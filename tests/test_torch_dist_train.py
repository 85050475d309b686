"""Data-parallel training over a process group against the reference.

* The train step: the reduced qwen2, seeded by the reference's init, one
  AdamW step of a global batch of 4 rows whose labels are masked unevenly
  (rank 0's two rows keep 9 of 32 labels, rank 1's keep 31), on two
  spawned gloo ranks (``tests/torch_dist_ranks.py``) against the
  reference's step on a ``(2, 1)`` mesh of forced host devices (batch
  split over ``data``, compiled with ``xla_allow_excess_precision`` off,
  in a subprocess started beside the ranks) and against the port's step
  on one process. Tolerances are ``tests/test_torch_grads.py``'s for the
  bf16 step: the loss at rtol 1e-4; every updated parameter within one
  bf16 ulp of the reference's, but for entries whose gradient lies within
  4 bf16 ulps of its leaf's largest |gradient| of zero (there the first
  AdamW step, about lr * sign(g), may take either sign), and at most 1 %
  of entries 1 ulp apart. A mean of per-rank means would miss the loss by
  more than 5 times its tolerance: the ranks' label counts differ.
* ``reshard_tree`` on the parameters (the reference's checkpoint) from a
  (2, 2) mesh to (4, 1) and back on four ranks: the leaves equal, the
  (4, 1) slices of the spec's shape, and the (2, 2) slices gathered whole
  by rank 0 into a checkpoint the reference restores bit for bit.
* The launcher under torchrun's variables on two ranks (4 steps, a
  checkpoint every step, a fault at step 2 on both ranks): the losses of
  one process's loop at rtol 1e-3 (three more AdamW steps after the
  first), one restart each.
* The step builders take every family on (2, 1), (1, 2) and (2, 2)
  meshes (``tests/test_torch_tensor_parallel.py`` and
  ``tests/test_torch_tp_families.py`` run them there), and refuse a mesh
  of more than one device on one process.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro import configs as jconfigs
from repro.models import model as JM
from repro.train import checkpoint as JC
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as TS
from repro_torch.launch import steps as TSteps
from repro_torch.models import model as TM
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as TO

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
BF16_LOSS_RTOL = 1e-4
BF16_ULPS = 4
FLIP_SHARE = 0.01
LOOP_LOSS_RTOL = 1e-3

REF_SCRIPT = r"""
import os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.compat import make_mesh
from repro.launch import steps
from repro.models import model as M
from repro.train import optimizer as O
import torch_dist_ranks as R

tmp = sys.argv[1]
STRICT = {"xla_allow_excess_precision": False}
cfg = configs.get_config("qwen2-1.5b").reduced()
with np.load(os.path.join(tmp, "train_in.npz")) as f:
    arrays = dict(f)
like = M.abstract_params(cfg)
host = R._tree(arrays, "p/")
params = jax.tree.map(lambda l, a: jnp.asarray(a.view(l.dtype)), like, host)
mesh = make_mesh((2, 1), ("data", "model"))
batch = {k: jax.device_put(jnp.asarray(arrays["b/" + k]),
                           NamedSharding(mesh, P("data", None)))
         for k in ("tokens", "labels")}
opt = O.AdamW(lr=O.cosine_schedule(3e-3, 1, 12))
grads = jax.jit(jax.grad(lambda p: M.loss_fn(cfg, p, batch))).lower(
    params).compile(compiler_options=STRICT)(params)
step, _ = steps.build_train_step(cfg, mesh, optimizer=opt)
state = opt.init(params)
new, _, loss = step.lower(params, state, batch).compile(
    compiler_options=STRICT)(params, state, batch)
out = {"loss": np.asarray(loss)}
for key, a in R._flat(jax.tree.map(np.asarray, new)):
    out["p/" + "/".join(key)] = a.astype(np.float32)
for key, a in R._flat(jax.tree.map(np.asarray, grads)):
    out["g/" + "/".join(key)] = a.astype(np.float32)
np.savez(os.path.join(tmp, "ref.npz"), **out)
"""


def _cfgs():
    return (jconfigs.get_config("qwen2-1.5b").reduced(),
            tconfigs.get_config("qwen2-1.5b").reduced())


def _uneven_batch(cfg, b=4, s=16, seed=9):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, 3:] = -1                       # rank 0 keeps 3 + 6 labels
    labels[1, 6:] = -1
    labels[2, :1] = -1                       # rank 1 keeps 15 + 16
    return toks, labels


def _f32(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def bf16_ulp(top: float) -> float:
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """The reference's (2, 1) step and the ranks', run at once, from the
    reference's seeded parameters."""
    tmp = str(tmp_path_factory.mktemp("train2"))
    jcfg, tcfg = _cfgs()
    params = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                     jax.random.key(2)))
    toks, labels = _uneven_batch(jcfg)
    arrays = {"b/tokens": toks, "b/labels": labels}
    for key, a in R._flat(params):
        arrays["p/" + "/".join(key)] = (a.view(np.uint16)
                                        if a.dtype.name == "bfloat16" else a)
    np.savez(os.path.join(tmp, "train_in.npz"), **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join(
                   [SRC, TESTS, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, tmp], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        R.spawn(R.train_rank, 2, tmp)
        _, err = proc.communicate(timeout=400)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    # the port on one process, same parameters and global batch
    tparams = TM.from_host(tcfg, params, device="cpu")
    opt = TO.AdamW(lr=TO.cosine_schedule(3e-3, 1, 12))
    step, _ = TSteps.build_train_step(tcfg, None, optimizer=opt)
    batch = dict(tokens=torch.from_numpy(toks),
                 labels=torch.from_numpy(labels))
    tparams, _, tloss = step(tparams, opt.init(tparams), batch)
    one = {"p/" + "/".join(k): _f32(v)
           for k, v in R._flat(TM.to_host(tparams))}
    one["loss"] = float(tloss)
    return (dict(np.load(os.path.join(tmp, "ref.npz"))),
            R.load(tmp, "train", 0), one)


def _assert_params_within_ulps(got: dict, want: dict, grads: dict, what):
    flips = total = 0
    for key in [k for k in want if k.startswith("p/")]:
        g = grads["g/" + key[2:]]
        tol = BF16_ULPS * bf16_ulp(float(np.max(np.abs(g))))
        a, b = _f32(got[key]), _f32(want[key])
        diff = np.abs(a - b)
        ulp = np.spacing(np.abs(b).astype(np.float32)) * 2.0 ** 16
        either_sign = np.abs(g) <= tol
        assert np.all((diff <= ulp) | either_sign), (what, key)
        flips += int(np.sum((diff > 0) & ~either_sign))
        total += diff.size
    print(f"{what}: 1-ulp flips {flips} of {total}")
    assert flips <= FLIP_SHARE * total, (what, flips, total)


def test_data_parallel_loss_is_the_global_batch_mean(step_run):
    ref, dp, one = step_run
    np.testing.assert_allclose(float(dp["loss"]), float(ref["loss"]),
                               rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(float(dp["loss"]), one["loss"],
                               rtol=BF16_LOSS_RTOL)


def test_data_parallel_params_match_reference_mesh(step_run):
    ref, dp, _ = step_run
    _assert_params_within_ulps(dp, ref, ref, "2 ranks vs the (2, 1) mesh")


def test_data_parallel_params_match_one_process(step_run):
    ref, dp, one = step_run
    _assert_params_within_ulps(dp, one, ref, "2 ranks vs one process")


def test_mean_of_rank_means_would_differ(step_run):
    """The uneven masks make a mean of the two ranks' own means a
    different number: the check above can tell the two apart."""
    jcfg, tcfg = _cfgs()
    toks, labels = _uneven_batch(jcfg)
    params = TM.from_host(tcfg, jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.key(2))), device="cpu")
    with torch.no_grad():
        halves = [float(TM.loss_fn(tcfg, params, dict(
            tokens=torch.from_numpy(toks[r:r + 2]),
            labels=torch.from_numpy(labels[r:r + 2])))) for r in (0, 2)]
    ref, _, _ = step_run
    assert abs(np.mean(halves) - float(ref["loss"])) > 5 * (
        BF16_LOSS_RTOL * float(ref["loss"]))


@pytest.fixture(scope="module")
def reshard_run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("reshard4"))
    jcfg, _ = _cfgs()
    params = JM.init_params(jcfg, jax.random.key(3))
    JC.save(os.path.join(tmp, "ref_ckpt"), 1, params)
    R.spawn(R.reshard_rank, 4, tmp)
    return tmp, params, [R.load(tmp, "reshard", r) for r in range(4)]


def test_reshard_params_2x2_to_4x1_and_back(reshard_run):
    """Every rank's (4, 1) slice has the spec's shape (the ranks also
    checked the round trip's leaves equal, and raise otherwise)."""
    _, params, ranks = reshard_run
    _, tcfg = _cfgs()

    class Mesh41:
        shape = {"data": 4, "model": 1}
        axis_names = ("data", "model")

    layout = TS.param_layout(TM.abstract_params(tcfg))
    specs = TS.param_spec_tree(tcfg, layout, Mesh41())
    for key, shape in R._flat(layout):
        spec = dict(R._flat(specs))[key]
        want = [n // (4 if e == "data" else 1) for n, e in zip(
            shape, tuple(spec) + (None,) * len(shape))]
        for got in ranks:
            assert list(got["s41/" + "/".join(key)]) == want, key


def test_reshard_checkpoint_crosses_packages(reshard_run):
    """The (2, 2) slices of the reference's checkpoint, gathered by the
    port and written by it, restore in the reference bit for bit."""
    tmp, params, _ = reshard_run
    back = JC.restore(os.path.join(tmp, "port_ckpt"), 1, params)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8),
                                      err_msg=str(path))


def test_launcher_under_torchrun_variables(tmp_path):
    """Two ranks through ``launch.train.main`` (env variables, gloo, a
    file store) against one process's loop: the losses, one restart and
    four steps each."""
    R.spawn(R.loop_rank, 2, str(tmp_path))
    ranks = [R.load(str(tmp_path), "loop", r) for r in range(2)]
    _, tcfg = _cfgs()
    fired = []

    def hook(step):
        if step == 2 and not fired:
            fired.append(step)
            raise RuntimeError("injected fault")

    rep = TL.train(tcfg, None, steps=4, global_batch=4, seq_len=16,
                   ckpt_dir=str(tmp_path / "one"), ckpt_every=1,
                   optimizer=TO.AdamW(lr=TO.cosine_schedule(3e-3, 0, 4)),
                   fault_hook=hook, log_every=0, device="cpu")
    for got in ranks:
        assert int(got["rc"]) == 0
        assert int(got["restarts"]) == 1 == rep.restarts
        assert int(got["steps_run"]) == 4 == rep.steps_run
        np.testing.assert_allclose(got["losses"], rep.losses,
                                   rtol=LOOP_LOSS_RTOL)
        np.testing.assert_array_equal(got["losses"], ranks[0]["losses"])


def test_moe_and_model_axis_refused():
    """Every family's three steps build on (2, 1), (1, 2), (2, 2), (1, 1)
    and (pod, data, model) = (2, 1, 2)
    (``tests/test_torch_tensor_parallel.py`` and
    ``tests/test_torch_tp_families.py`` run them there), and a mesh of more
    than one device on one process is refused as before."""
    class Mesh:
        def __init__(self, data, model, local_size=1, pod=None):
            self.shape = (data, model) if pod is None else (pod, data, model)
            self.axis_names = ("data", "model") if pod is None else (
                "pod", "data", "model")
            self.local_size = local_size

    _, tcfg = _cfgs()
    for arch in ("moonshot-v1-16b-a3b", "mamba2-370m", "recurrentgemma-9b",
                 "whisper-small", "llama-3.2-vision-90b"):
        cfgs = (tconfigs.get_config(arch).reduced(),) + (
            (tcfg,) if arch == "moonshot-v1-16b-a3b" else ())
        for cfg in cfgs:
            for mesh in (Mesh(2, 1), Mesh(1, 2), Mesh(2, 2), Mesh(1, 1),
                         Mesh(1, 2, pod=2)):
                for build in (TSteps.build_train_step,
                              TSteps.build_prefill_step,
                              TSteps.build_serve_step):
                    step, abstract = build(cfg, mesh)
                    assert callable(step) and "params" in abstract
    with pytest.raises(NotImplementedError, match="one process"):
        TSteps.build_train_step(tcfg, Mesh(2, 1, local_size=2))
