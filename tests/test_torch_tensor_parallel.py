"""Tensor parallelism on a ``model`` axis and data-parallel MoE over a
process group, against the reference's steps on the same meshes.

Four gloo ranks are spawned once (``tests/torch_dist_ranks.py``,
``tp_rank``); the 2-rank meshes are the first two ranks'
(``ProcessGroupMesh.sub``). Beside them one subprocess runs the reference
on 4 forced host devices (``REF_SCRIPT``: ``impl="ref"`` throughout, each
step compiled with ``xla_allow_excess_precision`` off). Both start from the
reference's seeded parameters of the reduced configs with a vocabulary of
504 (``ModelConfig.reduced()`` has 503, which is odd: it would stay
replicated at m = 2). The dense config's kv heads (2) split at m = 2 and
are replicated at m = 4, where each rank's q head reads the kv head of its
global index.

* On meshes (1, 2), (2, 2), (1, 4) and (2, 1, 2) (pod, data, model): one
  AdamW step against the reference's step on the same mesh, with
  ``tests/test_torch_grads.py``'s bf16 tolerances (the loss at rtol 1e-4;
  every parameter within one bf16 ulp outside the entries whose gradient
  lies within 4 bf16 ulps of its leaf's largest of zero, where the first
  AdamW step may take either sign; at most 1 % of entries 1 ulp apart);
  the prefill logits and 4 decode steps' logits within 4 bf16 ulps of the
  largest |logit|.
* The reduced MoE with 4 experts, on (2, 1) with ``"sort"`` and
  ``"einsum"`` and on (1, 2): one ``moe_ffn`` call at a capacity factor
  that drops pairs routes every model rank's tokens alike, keeps exactly
  the reference's pairs (the whole batch's routing: the sort's global
  capacity and positions, the einsum's per-row groups), and its output is
  bit-equal to one process's (the expert-parallel sum has one nonzero
  term a pair); the data ranks' load-balance shares sum to one process's
  term, and a train step's loss is the reference's at rtol 1e-4.
* ``train.loop.train`` on (2, 2) (a checkpoint every step, a fault at
  step 2 on every rank, so a restore gives each rank its slices): the
  losses within 1e-3 of one process's loop, and the whole checkpoint that
  rank 0 wrote restores in the reference bit for bit.
* In process, on stand-in meshes: a rank's module holds the slices of one
  process's seeded draw, and its q heads read the kv head of their
  global index.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro import configs as jconfigs
from repro.models import model as JM
from repro.train import checkpoint as JC
from repro_torch.distributed.tensor_parallel import ModelParallel
from repro_torch.distributed import sharding as TS
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as TC
from repro_torch.train import loop as TL

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
BF16_LOSS_RTOL = 1e-4
BF16_ULPS = 4
LOGIT_ULPS = 4
FLIP_SHARE = 0.01
LOOP_LOSS_RTOL = 1e-3
AUX_RTOL = 1e-6
B, S = 4, 16

REF_SCRIPT = r"""
import dataclasses, os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs
from repro.launch import steps
from repro.models import model as M
from repro.train import optimizer as O
import torch_dist_ranks as R

tmp = sys.argv[1]
STRICT = {"xla_allow_excess_precision": False}
with np.load(os.path.join(tmp, "tp_in.npz")) as f:
    arrays = dict(f)


def cfg_of(arch):
    return dataclasses.replace(configs.get_config(arch).reduced(),
                               vocab_size=R.TP_VOCAB)


def params_of(cfg, prefix):
    like = M.abstract_params(cfg)
    return jax.tree.map(lambda l, a: jnp.asarray(a.view(l.dtype)), like,
                        R._tree(arrays, prefix))


def mesh_of(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def step_of(cfg, mesh, params, opts=None):
    opt = O.AdamW(lr=O.cosine_schedule(3e-3, 1, 12))
    step, _ = steps.build_train_step(cfg, mesh, optimizer=opt, opts=opts)
    state = opt.init(params)
    return step.lower(params, state, batch).compile(
        compiler_options=STRICT)(params, state, batch)


batch = {k: jnp.asarray(arrays["b/" + k]) for k in ("tokens", "labels")}
toks = batch["tokens"]
out = {}
cfg = cfg_of("qwen2-1.5b")
grads = jax.jit(jax.grad(lambda p: M.loss_fn(cfg, p, batch))).lower(
    params_of(cfg, "p/")).compile(compiler_options=STRICT)(
        params_of(cfg, "p/"))
for key, a in R._flat(jax.tree.map(np.asarray, grads)):
    out["g/" + "/".join(key)] = a.astype(np.float32)
for tag, (shape, axes) in R.TP_MESHES.items():
    mesh = mesh_of(shape, axes)
    params = params_of(cfg, "p/")
    pre, _ = steps.build_prefill_step(cfg, mesh)
    out[tag + "/prefill"] = np.asarray(pre.lower(params, {"tokens": toks})
                                       .compile(compiler_options=STRICT)(
                                           params, {"tokens": toks}))
    serve, _ = steps.build_serve_step(cfg, mesh)
    cache = M.init_cache(cfg, toks.shape[0], R.TP_DECODE_STEPS)
    dec = serve.lower(params, cache, toks[:, :1]).compile(
        compiler_options=STRICT)
    logits = []
    for t in range(R.TP_DECODE_STEPS):
        lg, cache = dec(params, cache, toks[:, t:t + 1])
        logits.append(np.asarray(lg))
    out[tag + "/decode"] = np.concatenate(logits, 1)
    new, _, loss = step_of(cfg, mesh, params)
    out[tag + "/loss"] = np.asarray(loss)
    for key, a in R._flat(jax.tree.map(np.asarray, new)):
        out[tag + "/p/" + "/".join(key)] = a.astype(np.float32)
mcfg = cfg_of("moonshot-v1-16b-a3b")
for tag, (shape, impl) in R.TP_MOE.items():
    _, _, loss = step_of(mcfg, mesh_of(shape, ("data", "model")),
                         params_of(mcfg, "q/"), {"moe_impl": impl})
    out[tag + "/loss"] = np.asarray(loss)
np.savez(os.path.join(tmp, "ref.npz"), **out)
"""


def _cfgs(arch):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(),
                               vocab_size=R.TP_VOCAB)
    return jcfg, R.tp_config(arch)


def _f32(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def bf16_ulp(top: float) -> float:
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def _flat_arrays(tree, prefix):
    out = {}
    for key, a in R._flat(tree):
        a = np.asarray(a)
        out[prefix + "/".join(key)] = (a.view(np.uint16)
                                       if a.dtype.name == "bfloat16" else a)
    return out


def _batch(cfg):
    """Four rows whose labels are masked unevenly over the data ranks."""
    rng = np.random.default_rng(27)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, 3:] = -1
    labels[2, :5] = -1
    return toks, labels


def _moe_input(cfg):
    x = np.random.default_rng(28).normal(size=(B, S, cfg.d_model))
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's run and the ranks', started together."""
    tmp = str(tmp_path_factory.mktemp("tp"))
    jcfg, _ = _cfgs("qwen2-1.5b")
    mjcfg, _ = _cfgs("moonshot-v1-16b-a3b")
    params = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                     jax.random.key(5)))
    mparams = jax.tree.map(np.asarray, JM.init_params(mjcfg,
                                                      jax.random.key(6)))
    toks, labels = _batch(jcfg)
    x = _moe_input(mjcfg)
    arrays = {"b/tokens": toks, "b/labels": labels,
              "x": x.view(np.uint16)}
    arrays.update(_flat_arrays(params, "p/"))
    arrays.update(_flat_arrays(mparams, "q/"))
    np.savez(os.path.join(tmp, "tp_in.npz"), **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [SRC, TESTS, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, tmp], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        R.spawn(R.tp_rank, 4, tmp)
        _, err = proc.communicate(timeout=400)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    ranks = [R.load(tmp, "tp", r) for r in range(4)]
    return dict(tmp=tmp, ref=dict(np.load(os.path.join(tmp, "ref.npz"))),
                ranks=ranks, params=params, mparams=mparams, x=x,
                toks=toks, labels=labels)


def _assert_params_within_ulps(got: dict, ref: dict, tag: str):
    flips = total = 0
    for key in [k for k in ref if k.startswith(tag + "/p/")]:
        name = key[len(tag) + 3:]
        g = ref["g/" + name]
        tol = BF16_ULPS * bf16_ulp(float(np.max(np.abs(g))))
        a, b = _f32(got[key]), _f32(ref[key])
        diff = np.abs(a - b)
        ulp = np.spacing(np.abs(b).astype(np.float32)) * 2.0 ** 16
        either_sign = np.abs(g) <= tol
        assert np.all((diff <= ulp) | either_sign), (tag, name)
        flips += int(np.sum((diff > 0) & ~either_sign))
        total += diff.size
    print(f"{tag}: 1-ulp flips {flips} of {total}")
    assert total and flips <= FLIP_SHARE * total, (tag, flips, total)


@pytest.mark.parametrize("tag", list(R.TP_MESHES))
def test_train_step_matches_reference_mesh(world, tag):
    got, ref = world["ranks"][0], world["ref"]
    np.testing.assert_allclose(float(got[tag + "/loss"]),
                               float(ref[tag + "/loss"]),
                               rtol=BF16_LOSS_RTOL)
    _assert_params_within_ulps(got, ref, tag)


@pytest.mark.parametrize("tag", list(R.TP_MESHES))
@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_prefill_and_decode_match_reference_mesh(world, tag, what):
    got = world["ranks"][0][f"{tag}/{what}"]
    want = world["ref"][f"{tag}/{what}"]
    assert got.shape == want.shape == (B, S if what == "prefill"
                                       else R.TP_DECODE_STEPS, R.TP_VOCAB)
    tol = LOGIT_ULPS * bf16_ulp(float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _ref_keep(wr, x, e, topk, cf, impl):
    """The reference's routing of the whole batch x [B, S, D]
    (src/repro/models/moe.py:45-67 and :125-131): the experts and the keep
    mask of every (token, slot) pair, the sort's over one global group
    (capacity from B * S tokens), the einsum's per batch row."""
    b, s, d = x.shape
    logits = jnp.dot(x.reshape(-1, d).astype(jnp.float32),
                     wr.astype(jnp.float32))
    _, expert = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), topk)
    if impl == "sort":
        cap = max(1, int(b * s * topk * cf / e))
        flat = expert.reshape(-1)
        oh = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    else:
        cap = max(1, int(s * topk * cf / e))
        oh = jax.nn.one_hot(expert.reshape(b, s * topk), e, dtype=jnp.int32)
    rank = jnp.sum((jnp.cumsum(oh, axis=-2) - oh) * oh, axis=-1)
    return np.asarray(expert), np.asarray(rank < cap).reshape(-1)


@pytest.mark.parametrize("tag", list(R.TP_MOE))
def test_moe_routes_and_kept_pairs_match_reference(world, tag):
    """Every model rank routes alike; the kept pairs are the reference's
    whole-batch routing's, and some pairs drop."""
    shape, impl = R.TP_MOE[tag]
    mjcfg, _ = _cfgs("moonshot-v1-16b-a3b")
    wr = world["mparams"]["blocks"]["moe"]["wr"][0]
    expert, keep = _ref_keep(jnp.asarray(wr), jnp.asarray(world["x"]),
                             mjcfg.num_experts, mjcfg.experts_per_token,
                             R.TP_MOE_CF, impl)
    r0, r1 = world["ranks"][:2]
    if shape[0] == 2:               # data ranks: each its block of rows
        got_e = np.concatenate([r0[tag + "/expert"], r1[tag + "/expert"]])
        got_k = np.concatenate([r0[tag + "/keep"].reshape(-1),
                                r1[tag + "/keep"].reshape(-1)])
    else:                           # model ranks: the same tokens
        np.testing.assert_array_equal(r0[tag + "/expert"],
                                      r1[tag + "/expert"])
        np.testing.assert_array_equal(r0[tag + "/keep"], r1[tag + "/keep"])
        got_e, got_k = r0[tag + "/expert"], r0[tag + "/keep"].reshape(-1)
    np.testing.assert_array_equal(got_e.astype(np.int32),
                                  expert.astype(np.int32))
    np.testing.assert_array_equal(got_k, keep)
    assert not keep.all()


@pytest.fixture(scope="module")
def moe_one(world):
    """The MoE's direct calls and train steps on one process."""
    _, mcfg = _cfgs("moonshot-v1-16b-a3b")
    x = torch.from_numpy(world["x"].view(np.int16).copy()).view(
        torch.bfloat16)
    batch = {"tokens": torch.from_numpy(world["toks"]),
             "labels": torch.from_numpy(world["labels"])}
    return {impl: R.tp_moe(mcfg, world["mparams"], batch, x, None, impl)
            for impl in ("sort", "einsum")}


@pytest.mark.parametrize("tag", list(R.TP_MOE))
def test_moe_output_bit_equal_to_one_process(world, moe_one, tag):
    """Given the same routes (the test above), the experts' output is one
    process's bit for bit: over data ranks each row is computed in a
    buffer of the global capacity, over model ranks each pair's
    contribution is summed with zeros."""
    shape, impl = R.TP_MOE[tag]
    r0, r1 = world["ranks"][:2]
    want = moe_one[impl]
    if shape[0] == 2:
        y = np.concatenate([r0[tag + "/y"], r1[tag + "/y"]])
        aux = float(r0[tag + "/aux"]) + float(r1[tag + "/aux"])
        np.testing.assert_allclose(aux, float(want["aux"]), rtol=AUX_RTOL)
    else:
        y = r0[tag + "/y"]
        np.testing.assert_array_equal(r1[tag + "/y"], y)
        assert float(r0[tag + "/aux"]) == float(want["aux"])
    np.testing.assert_array_equal(y, want["y"].numpy())


@pytest.mark.parametrize("tag", list(R.TP_MOE))
def test_moe_train_loss_matches_reference_mesh(world, tag):
    """The ranks' loss (load-balance term included, each data rank adding
    its share) is the reference's whole-batch loss on the same mesh."""
    np.testing.assert_allclose(float(world["ranks"][0][tag + "/loss"]),
                               float(world["ref"][tag + "/loss"]),
                               rtol=BF16_LOSS_RTOL)


def test_loop_on_2x2_matches_one_process_and_checkpoint_crosses(world,
                                                                tmp_path):
    """The loop over (2, 2) against one process's loop (the same seeded
    init, data, fault and restart), and its last checkpoint, gathered whole
    by rank 0, restored by the reference bit for bit."""
    jcfg, tcfg = _cfgs("qwen2-1.5b")
    fired = []

    def hook(step):
        if step == 2 and not fired:
            fired.append(step)
            raise RuntimeError("injected fault")

    rep = TL.train(tcfg, None, steps=R.TP_LOOP_STEPS, global_batch=B,
                   seq_len=S, ckpt_dir=str(tmp_path / "one"), ckpt_every=1,
                   optimizer=R.tp_optimizer(R.TP_LOOP_STEPS, 0),
                   fault_hook=hook, log_every=0, device="cpu")
    for got in world["ranks"]:
        assert int(got["loop/restarts"]) == 1 == rep.restarts
        np.testing.assert_allclose(got["loop/losses"], rep.losses,
                                   rtol=LOOP_LOSS_RTOL)
    ckpt = os.path.join(world["tmp"], "loop_ckpt")
    like = JM.init_params(jcfg, jax.random.key(0))
    back = JC.restore(ckpt, R.TP_LOOP_STEPS, like)
    port = TC.restore(ckpt, R.TP_LOOP_STEPS, TM.stack(
        TM.abstract_params(tcfg).named_parameters()))
    want = {"/".join(k): v for k, v in R._flat(port)}
    for path, a in jax.tree_util.tree_flatten_with_path(back)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        b = want[key]
        b = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      b.numpy().view(np.uint8), err_msg=key)


@pytest.mark.parametrize("m, rank, kv_of, block", [
    (2, 0, [0, 0, 0, 0, 0, 0], (0, 1)),     # the kv heads split
    (4, 1, [0, 0, 0], (0, 1)),              # replicated: global kv 0
    (4, 2, [1, 1, 1], (1, 1)),
    (4, 3, [1, 1, 1], (1, 1))])
def test_local_q_heads_read_their_global_kv_head(m, rank, kv_of, block):
    """qwen2-1.5b (12 q heads, 2 kv heads): at m = 2 each rank holds one
    kv head, its own; at m = 4 every rank holds both and its 3 q heads read
    the kv head of their global index."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-1.5b")

    class Mesh:
        shape = (1, m)
        axis_names = ("data", "model")
        coords = (0, rank)

    mp = ModelParallel(cfg, Mesh())
    assert (mp.heads, mp.kv, mp.vocab, mp.mlp) == (True, m == 2, True, True)
    assert mp.kv_of == kv_of and mp.kv_block() == block


@pytest.mark.parametrize("arch, m", [("qwen2-1.5b", 2), ("qwen2-1.5b", 4),
                                     ("moonshot-v1-16b-a3b", 2)])
def test_rank_module_holds_its_slices_of_one_draw(arch, m):
    """A rank's module (``init_params(..., mesh)``) holds, for every
    parameter, the slice ``shard_leaf`` cuts from one process's draw, of
    the shape ``local_shape`` gives."""
    _, cfg = _cfgs(arch)

    class Mesh:
        shape = (1, m)
        axis_names = ("data", "model")
        coords = (0, m - 1)

    one = TM.init_params(cfg, 3, "cpu")
    mine = TM.init_params(cfg, 3, "cpu", Mesh())
    specs = TS.param_specs(cfg, Mesh())
    whole = dict(one.named_parameters())
    split = 0
    for name, p in mine.named_parameters():
        assert p.shape == TS.local_shape(whole[name].shape, specs[name],
                                         Mesh()), name
        assert torch.equal(p, TS.shard_leaf(whole[name], specs[name],
                                            Mesh())), name
        split += TS.on_axis(specs[name])
    assert split and mine.mp.size == m and mine.mp.index == m - 1
