"""Gradients of the port: repro_torch's flash attention, loss and train step
against repro's, on the CPU.

* ``flash_attention`` forward and VJP against the reference's
  ``flash_attention`` and ``jax.vjp``, in float32, at Sq = Sk = 64 and
  1 300 (above ``chunk_k`` = 1 024 and not a multiple of it: the keys are
  padded), causal and not, with a window, GQA: the output and dq / dk / dv
  within 2e-6 of each one's largest |value| (the sums run in another order;
  the gaps seen are under 5e-7).
* ``loss_fn`` and the gradient of every parameter at each family's
  ``reduced()`` config in float32 (one parametrised test): the loss at rtol
  1e-5 and each gradient leaf within 2e-5 of its largest |entry| (the
  worst gaps, printed with ``-s``, are about 1.5e-6), or within 1e-7 of
  the model's largest gradient where that is more: a leaf whose gradient
  is zero in exact arithmetic (the key bias of a softmax attention) holds
  rounding noise only, about 1e-9 where the largest gradients are 0.2.
* One whole ``build_train_step`` of the dense config in bf16 against the
  reference's on a 1 x 1 mesh (compiled with ``xla_allow_excess_precision``
  off, so its bf16 casts round as written): the loss at rtol 1e-4 (bf16
  roundings of the residual stream flip between the two; the gap seen is
  1.2e-5), each
  gradient leaf within 4 bf16 ulps of its largest |entry|, and the updated
  parameters equal but for at most 1 % of 1-ulp flips and the entries whose
  gradient lies within that tolerance of zero (there the first AdamW step,
  about lr * sign(g), may take either sign).
* ``moe_ffn(impl="einsum")`` against the reference's at capacities that
  drop pairs: the experts, ranks and keep mask equal, the output within a
  bf16 ulp of each value, aux at rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.compat import make_mesh
from repro.launch import steps as JSteps
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.train import optimizer as JO
from repro_torch import configs as tconfigs
from repro_torch.launch import steps as TSteps
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.train import optimizer as TO

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

STRICT = {"xla_allow_excess_precision": False}
FLASH_TOL = 2e-6
GRAD_TOL = 2e-5
NOISE_FLOOR = 1e-7
BF16_LOSS_RTOL = 1e-4
BF16_ULPS = 4
FLIP_SHARE = 0.01
FAMILIES = ("qwen2-1.5b", "moonshot-v1-16b-a3b", "mamba2-370m",
            "recurrentgemma-9b", "whisper-small", "llama-3.2-vision-90b")


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a) -> torch.Tensor:
    return TM._tensor(np.asarray(a))


def rel_gap(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def bf16_ulp(top: float) -> float:
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


# ---------------------------------------------------------------- flash ---
@pytest.mark.parametrize("s, heads, kv, causal, window", [
    (64, 4, 2, True, 0),
    (1300, 4, 2, True, 0),
    (1300, 4, 4, False, 0),
    (1300, 4, 1, True, 500),
])
def test_flash_attention_and_vjp_match_reference(s, heads, kv, causal,
                                                 window):
    rng = np.random.default_rng(s + heads + kv + window)
    q = rng.normal(size=(2, s, heads, 16)).astype(np.float32)
    k = rng.normal(size=(2, s, kv, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, kv, 16)).astype(np.float32)
    dout = rng.normal(size=(2, s, heads, 16)).astype(np.float32)

    def ref(q, k, v):
        return JL.flash_attention(q, k, v, causal=causal, window=window)

    jout, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout = TL.flash_attention(tq, tk, tv, causal=causal, window=window)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(dout))
    gaps = [rel_gap(tout, jout)] + [rel_gap(a, b)
                                    for a, b in zip(tgrads, jgrads)]
    print(f"flash s={s} kv={kv} causal={causal} window={window}: out, dq, "
          f"dk, dv gaps {gaps}")
    assert max(gaps) <= FLASH_TOL


def test_attention_is_flash_attention():
    """``layers.attention``, the forward path every family serves with, is
    the flash Function: at Sk <= chunk_k one kv chunk, the one-block
    result."""
    assert TL.attention is TL.flash_attention
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 40, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 40, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 40, 2, 16)).astype(np.float32))
    assert rel_gap(TL.attention(q, k, v),
                   TL.attention_one_block(q, k, v)) <= FLASH_TOL


# ------------------------------------------------------- loss and grads ---
def _batch(cfg, seed=5, b=2, s=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1                       # masked positions
    jb = dict(tokens=jnp.asarray(toks), labels=jnp.asarray(labels))
    tb = dict(tokens=torch.from_numpy(toks), labels=torch.from_numpy(labels))
    if cfg.num_frontend_tokens:
        fe = (rng.normal(size=(b, cfg.num_frontend_tokens, cfg.d_model))
              * 0.5).astype(np.float32)
        fe = np.asarray(jnp.asarray(fe, jnp.dtype(cfg.dtype)))
        jb["frontend_embeds"], tb["frontend_embeds"] = jnp.asarray(fe), _t(fe)
    return jb, tb


def _port_grads(tcfg, tparams, tb, **kw):
    tparams.requires_grad_(True)
    named = list(tparams.named_parameters())
    loss = TM.loss_fn(tcfg, tparams, tb, **kw)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss, {n: g for (n, _), g in zip(named, grads)}


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_every_gradient_match_reference(name):
    cfg = dataclasses.replace(jconfigs.get_config(name).reduced(),
                              dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config(name).reduced(),
                               dtype="float32")
    params = JM.init_params(cfg, jax.random.key(1))
    # the gate opens vlm's cross-attention (zero at init, as the reference)
    if cfg.family == "vlm":
        params["cross_blocks"]["gate"] = jnp.full_like(
            params["cross_blocks"]["gate"], 0.5)
    jb, tb = _batch(cfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(cfg, p, jb))(params)
    tparams = TM.from_host(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    tloss, tgrads = _port_grads(tcfg, tparams, tb)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    want = TM.unstack(tcfg, jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(tgrads)
    gaps = {n: rel_gap(tgrads[n], want[n]) for n in want
            if float(np.max(np.abs(_f32(want[n])))) > 0}
    worst = max(gaps, key=gaps.get)
    print(f"{name}: loss {float(tloss.detach())} vs {float(jloss)}; worst "
          "gradient "
          f"gap {gaps[worst]:.3g} of its largest |entry| at {worst}")
    floor = NOISE_FLOOR * max(float(np.max(np.abs(_f32(w))))
                              for w in want.values())
    for n in want:
        np.testing.assert_allclose(
            _f32(tgrads[n]), _f32(want[n]), rtol=0,
            atol=max(GRAD_TOL * float(np.max(np.abs(_f32(want[n])))), floor),
            err_msg=n)


def test_dense_train_step_matches_reference_in_bf16():
    cfg = jconfigs.get_config("qwen2-1.5b").reduced()
    tcfg = tconfigs.get_config("qwen2-1.5b").reduced()
    jopt = JO.AdamW(lr=JO.cosine_schedule(3e-3, 1, 12))
    topt = TO.AdamW(lr=TO.cosine_schedule(3e-3, 1, 12))
    params = JM.init_params(cfg, jax.random.key(2))
    host = jax.tree.map(np.asarray, params)
    jb, tb = _batch(cfg, seed=9, b=4, s=16)
    jgrads = jax.jit(jax.grad(lambda p: JM.loss_fn(cfg, p, jb))).lower(
        params).compile(compiler_options=STRICT)(params)
    step, _ = JSteps.build_train_step(cfg, make_mesh((1, 1),
                                                     ("data", "model")),
                                      optimizer=jopt)
    state = jopt.init(params)
    compiled = step.lower(params, state, jb).compile(
        compiler_options=STRICT)
    new_params, _, jloss = compiled(params, state, jb)
    want_params = TM.unstack(tcfg, jax.tree.map(np.asarray, new_params))
    want_grads = TM.unstack(tcfg, jax.tree.map(np.asarray, jgrads))

    tparams = TM.from_host(tcfg, host, device="cpu")
    _, tgrads = _port_grads(tcfg, tparams, tb)
    tstep, _ = TSteps.build_train_step(tcfg, None, optimizer=topt)
    tparams, tstate, tloss = tstep(tparams, topt.init(tparams), tb)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=BF16_LOSS_RTOL)
    assert int(tstate.step) == 1
    got_params = dict(tparams.named_parameters())
    flips = total = 0
    for n, want in want_grads.items():
        tol = BF16_ULPS * bf16_ulp(float(np.max(np.abs(_f32(want)))))
        np.testing.assert_allclose(_f32(tgrads[n]), _f32(want), rtol=0,
                                   atol=tol, err_msg=n)
        got, exp = _f32(got_params[n]), _f32(want_params[n])
        diff = np.abs(got - exp)
        ulp = np.spacing(np.abs(exp).astype(np.float32)) * 2.0 ** 16
        either_sign = np.abs(_f32(want)) <= tol
        assert np.all((diff <= ulp) | either_sign), n
        flips += int(np.sum((diff > 0) & ~either_sign))
        total += diff.size
    print(f"dense bf16 step: 1-ulp flips {flips} of {total}")
    assert flips <= FLIP_SHARE * total


# ------------------------------------------------------------ moe einsum ---
def _ref_einsum_route(wr, x, e, topk, cf):
    """The reference's einsum routing (src/repro/models/moe.py:46-50 and
    :125-131): experts, per-group ranks and the keep mask."""
    g, s, d = x.shape
    logits = jnp.dot(x.reshape(-1, d).astype(jnp.float32),
                     wr.astype(jnp.float32))
    _, expert = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), topk)
    cap = max(1, int(s * topk * cf / e))
    oh = jax.nn.one_hot(expert.reshape(g, s, topk), e, dtype=jnp.int32)
    flat = oh.reshape(g, s * topk, e)
    rank = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat,
                   axis=-1).reshape(g, s, topk)
    return np.asarray(expert), np.asarray(rank), np.asarray(rank < cap)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_einsum_matches_reference(cf):
    cfg = jconfigs.get_config("moonshot-v1-16b-a3b").reduced()
    jp = JM.init_params(cfg, jax.random.key(4))["blocks"]["moe"]
    jp = jax.tree.map(lambda a: a[0], jp)
    tp = TM.from_host(tconfigs.get_config("moonshot-v1-16b-a3b").reduced(),
                      jax.tree.map(np.asarray, JM.init_params(
                          cfg, jax.random.key(4))), device="cpu").blocks[0].moe
    e, k = cfg.num_experts, cfg.experts_per_token
    x = np.asarray(jnp.asarray(np.random.default_rng(int(cf * 8)).normal(
        size=(3, 12, cfg.d_model)), jnp.bfloat16))
    expert, rank, keep = _ref_einsum_route(jp["wr"], jnp.asarray(x), e, k, cf)
    _, _, texpert, *_ = TMoE.route(tp.wr, _t(x).reshape(-1, cfg.d_model), e,
                                   k, cf)
    trank, tkeep, _ = TMoE.group_ranks(texpert, 3, e, cf)
    np.testing.assert_array_equal(texpert.numpy(), expert)
    np.testing.assert_array_equal(trank.numpy(), rank)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    assert not keep.all()                    # pairs dropped
    jy, jaux = JMoE.moe_ffn(jp, jnp.asarray(x), num_experts=e,
                            experts_per_token=k, capacity_factor=cf,
                            act=cfg.mlp_act, impl="einsum")
    ty, taux = TMoE.moe_ffn(tp, _t(x), num_experts=e, experts_per_token=k,
                            capacity_factor=cf, act=cfg.mlp_act,
                            impl="einsum")
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=2.0 ** -7,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
