"""The dense decoder: repro_torch.configs and repro_torch.models against
repro.configs / repro.models, on the CPU.

Each arch's reduced config runs in both packages on the same parameters:
the reference's ``init_params(cfg, jax.random.key(0))`` carried over by
``model.from_host``. qwen2-1.5b brings the QKV bias, GQA and tied
embeddings; gemma-2b the tanh GeGLU, MQA and a head_dim apart from
d_model / heads; qwen1.5-4b an untied ``lm_head`` and MHA. The reference is
computed once per arch, in a module fixture.

Tolerances. Both packages accumulate each product in float32 and round it
once to bf16; they differ in the order of the float32 sums and in the last
bits of silu / gelu / the rope frequencies, so a bf16 rounding may fall on
the other side: a layer's bf16 output is held to one bf16 ulp of each
value (rtol 2**-7), the float32 rope frequencies to rtol 1e-6. Over the
whole model such flips add up: logits and the KV caches are held to 4 bf16
ulps of their largest |value| (the measured gaps are 1.0-2.2 of them), and
tokens are compared only where the reference's top-2 margin exceeds twice
that. In float32 the port's decode is held to its own forward at rtol =
atol = 2e-3 (tests/test_models.py), and to the reference's forward at
1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

ARCHS = ("qwen2-1.5b", "gemma-2b", "qwen1.5-4b")
DENSE = tuple(n for n in jconfigs.ARCH_NAMES
              if jconfigs.get_config(n).family == "dense")
UNPORTED = tuple(n for n in jconfigs.ARCH_NAMES if n not in DENSE)
B, S, STEPS, MAX_SEQ = 2, 12, 9, 16
BF16_RTOL = 2.0 ** -7        # one bf16 ulp of each value
LOGIT_ULPS = 4               # bf16 ulps of the largest |logit|


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a) -> torch.Tensor:
    """A reference array as a port tensor, bits kept (bf16 included)."""
    return TM._tensor(np.asarray(a))


def bf16_tol(ref) -> float:
    """LOGIT_ULPS bf16 ulps of the largest |value| of ``ref``."""
    top = float(np.max(np.abs(_f32(ref))))
    return LOGIT_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


def assert_tokens_agree(got_logits, ref_logits, tol):
    """argmax equal wherever the reference's top-2 margin exceeds 2 * tol;
    prints and returns the share of positions compared."""
    ref = np.asarray(ref_logits, np.float32)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * tol
    np.testing.assert_array_equal(np.argmax(got_logits, -1)[sure],
                                  np.argmax(ref, -1)[sure])
    print(f"tokens compared at {np.mean(sure):.3f} of the positions "
          f"(top-2 margin > {2 * tol:.4g})")
    return float(np.mean(sure))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """The reference's params, logits and caches for one reduced arch."""
    name = request.param
    cfg = jconfigs.get_config(name).reduced()
    params = JM.init_params(cfg, jax.random.key(0))
    host = jax.tree.map(np.asarray, params)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    logits, _ = JM.forward(cfg, params, dict(tokens=jnp.asarray(toks)))
    step = jax.jit(functools.partial(JM.decode_step, cfg))
    cache = JM.init_cache(cfg, B, MAX_SEQ)
    dec = []
    for t in range(STEPS):
        lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]))
        dec.append(np.asarray(lg[:, 0]))
    return dict(name=name, cfg=cfg, params=params, host=host, toks=toks,
                logits=np.asarray(logits), dec=np.stack(dec, 1),
                cache=jax.tree.map(np.asarray, cache),
                tcfg=tconfigs.get_config(name).reduced(),
                tparams=TM.from_host(tconfigs.get_config(name).reduced(),
                                     host, device="cpu"))


# ---------------------------------------------------------------- configs ---
@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_configs_match_reference(name):
    jc, tc = jconfigs.get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert dataclasses.asdict(jc.reduced()) == dataclasses.asdict(tc.reduced())
    assert (jc.resolved_head_dim, jc.sub_quadratic) == (
        tc.resolved_head_dim, tc.sub_quadratic)
    for shape in jconfigs.SHAPES:
        assert jconfigs.shape_applicable(jc, shape) == \
            tconfigs.shape_applicable(tc, shape)
    assert {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()}
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


# ----------------------------------------------------------------- layers ---
def test_layers_match_reference(arch):
    """Block 0's layers on a hidden state of the arch's widths."""
    cfg, host = arch["cfg"], arch["host"]
    blk = arch["tparams"].blocks[0]
    jblk = jax.tree.map(lambda a: jnp.asarray(a[0]), host["blocks"])
    rng = np.random.default_rng(1)
    x = np.asarray(jnp.asarray(rng.normal(size=(B, S, cfg.d_model)),
                               jnp.bfloat16))
    scale = (0.1 * rng.normal(size=cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    hd, h, kv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads

    def close(got, want, rtol=BF16_RTOL, atol=1e-6):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                   atol=atol)

    close(TL.rms_norm(_t(x), _t(scale), cfg.norm_eps),
          JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), cfg.norm_eps))
    close(TL.rope_freqs(hd, cfg.rope_theta),
          JL.rope_freqs(hd, cfg.rope_theta), rtol=1e-6)
    tq = TL.qkv_project(blk.attn, _t(x), h, kv, hd)
    jq = JL.qkv_project(jblk["attn"], jnp.asarray(x), h, kv, hd)
    for got, want in zip(tq, jq):
        close(got, want)
    q, k, v = (np.asarray(a) for a in jq)
    close(TL.apply_rope(_t(q), _t(pos), cfg.rope_theta),
          JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), cfg.rope_theta))
    for window in (0, 5):
        close(TL.attention(_t(q), _t(k), _t(v), window=window),
              JL.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window=window))
    close(TL.attention(_t(q[:, 4:]), _t(k), _t(v), q_offset=4),
          JL.flash_attention(jnp.asarray(q[:, 4:]), jnp.asarray(k),
                             jnp.asarray(v), q_offset=4))
    cache_len = np.array([5, S], np.int32)
    for window in (0, 3):
        close(TL.decode_attention(_t(q[:, :1]), _t(k), _t(v),
                                  _t(cache_len), window=window),
              JL.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(cache_len),
                                  window=window))
    o = np.asarray(jnp.asarray(rng.normal(size=(B, S, h, hd)), jnp.bfloat16))
    close(TL.out_project(blk.attn, _t(o)),
          JL.out_project(jblk["attn"], jnp.asarray(o)))
    close(TL.gated_mlp(blk.mlp, _t(x), cfg.mlp_act),
          JL.gated_mlp(jblk["mlp"], jnp.asarray(x), cfg.mlp_act))


def test_dense_mlp_matches_reference():
    """The two-matrix MLP (``mlp_act="gelu_mlp"``) with its biases."""
    rng = np.random.default_rng(2)
    p = {k: np.asarray(jnp.asarray(rng.normal(size=s) * 0.3, jnp.bfloat16))
         for k, s in dict(w1=(64, 96), b1=(96,), w2=(96, 64),
                          b2=(64,)).items()}
    x = np.asarray(jnp.asarray(rng.normal(size=(2, 5, 64)), jnp.bfloat16))
    tp = torch.nn.Module()
    for k, a in p.items():
        setattr(tp, k, _t(a))
    np.testing.assert_allclose(
        _f32(TL.dense_mlp(tp, _t(x))),
        _f32(JL.dense_mlp({k: jnp.asarray(a) for k, a in p.items()},
                          jnp.asarray(x))), rtol=BF16_RTOL, atol=1e-6)


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh approximation; the port's GeGLU
    must use it too (the exact erf form is ~1e-3 away)."""
    x = np.linspace(-4, 4, 801, dtype=np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(TL._act("gelu", torch.from_numpy(x)).numpy(),
                               ref, rtol=1e-6, atol=1e-6)
    assert np.max(np.abs(F.gelu(torch.from_numpy(x)).numpy() - ref)) > 1e-4


def test_tied_embedding_scale_is_rounded_first():
    """sqrt(d_model) is rounded to bf16 before it multiplies: 39.25 for
    1 536 (not 39.19); the scaled embedding equals the reference's bit for
    bit."""
    cfg = tconfigs.get_config("qwen2-1.5b")
    assert float(torch.tensor(cfg.d_model ** 0.5, dtype=torch.bfloat16)) \
        == 39.25
    red = cfg.reduced()
    jparams = JM.init_params(jconfigs.get_config("qwen2-1.5b").reduced(),
                             jax.random.key(3))
    tparams = TM.from_host(red, jax.tree.map(np.asarray, jparams),
                           device="cpu")
    toks = np.arange(10, dtype=np.int32)[None]
    want = jparams["embed"][toks] * jnp.asarray(red.d_model ** 0.5,
                                                jnp.bfloat16)
    got = TT._embed(red, tparams, torch.from_numpy(toks))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


# ------------------------------------------------------------------ model ---
def test_forward_matches_reference(arch):
    logits, aux = TM.forward(arch["tcfg"], arch["tparams"],
                             dict(tokens=torch.from_numpy(arch["toks"])))
    assert logits.dtype == torch.float32 and aux == 0.0
    assert logits.shape == (B, S, arch["cfg"].vocab_size)
    tol = bf16_tol(arch["logits"])
    np.testing.assert_allclose(logits.numpy(), arch["logits"], rtol=0,
                               atol=tol)
    assert assert_tokens_agree(logits.numpy(), arch["logits"], tol) > 0


def test_decode_steps_match_reference(arch):
    """9 decode steps: logits, the caches and cache_len."""
    tcfg, tparams, toks = arch["tcfg"], arch["tparams"], arch["toks"]
    cache = TM.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    dec = []
    for t in range(STEPS):
        lg, cache = TM.decode_step(tcfg, tparams, cache,
                                   torch.from_numpy(toks[:, t:t + 1]))
        dec.append(lg[:, 0].numpy())
    dec = np.stack(dec, 1)
    tol = bf16_tol(arch["dec"])
    np.testing.assert_allclose(dec, arch["dec"], rtol=0, atol=tol)
    assert assert_tokens_agree(dec, arch["dec"], tol) > 0
    ref = arch["cache"]
    np.testing.assert_array_equal(cache["cache_len"].numpy(),
                                  ref["cache_len"])
    assert cache["cache_len"].dtype == torch.int32
    for key in ("k", "v"):
        assert cache[key].dtype == torch.bfloat16
        # rows not yet written stay exactly zero
        assert not _f32(cache[key])[:, :, STEPS:].any()
        np.testing.assert_allclose(_f32(cache[key]), _f32(ref[key]),
                                   rtol=0, atol=bf16_tol(ref[key]))


def test_kv_write_wraps_at_max_seq():
    """The KV write position is cache_len mod max_seq: 7 steps into a
    4-row cache overwrite rows 0-2, as the reference's do."""
    name = "qwen2-1.5b"
    cfg = dataclasses.replace(jconfigs.get_config(name).reduced(),
                              dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config(name).reduced(),
                               dtype="float32")
    params = JM.init_params(cfg, jax.random.key(4))
    tparams = TM.from_host(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (B, 7)).astype(np.int32)
    jc, tc = JM.init_cache(cfg, B, 4), TM.init_cache(tcfg, B, 4,
                                                      device="cpu")
    for t in range(7):
        jl, jc = JM.decode_step(cfg, params, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = TM.decode_step(tcfg, tparams, tc,
                                torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=1e-4, atol=1e-5)
    assert tc["cache_len"].tolist() == [7, 7]


def test_float32_decode_matches_forward():
    """In float32 the port's decode equals its own forward (rtol 2e-3, as
    tests/test_models.py holds the reference's), and its forward the
    reference's at 1e-4."""
    for name in ("qwen2-1.5b", "gemma-2b"):
        cfg = dataclasses.replace(jconfigs.get_config(name).reduced(),
                                  dtype="float32")
        tcfg = dataclasses.replace(tconfigs.get_config(name).reduced(),
                                   dtype="float32")
        params = JM.init_params(cfg, jax.random.key(0))
        tparams = TM.from_host(tcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
        toks = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, 9)).astype(np.int32)
        full, _ = TM.forward(tcfg, tparams, dict(tokens=toks))
        cache = TM.init_cache(tcfg, B, MAX_SEQ, device="cpu")
        outs = []
        for t in range(9):
            lg, cache = TM.decode_step(tcfg, tparams, cache, toks[:, t:t + 1])
            outs.append(lg[:, 0])
        np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                                   full.numpy(), rtol=2e-3, atol=2e-3)
        ref, _ = JM.forward(cfg, params, dict(tokens=jnp.asarray(toks)))
        np.testing.assert_allclose(full.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------------------ host carry ---
def test_host_round_trip_is_bit_exact(arch):
    host = arch["host"]
    back = TM.to_host(arch["tparams"])
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    for p in arch["tparams"].parameters():
        assert not p.requires_grad
    bad = dict(host, final_norm=host["final_norm"][:-1])
    with pytest.raises(ValueError):
        TM.from_host(arch["tcfg"], bad, device="cpu")
    with pytest.raises(ValueError):
        TM.from_host(arch["tcfg"], dict(host, extra=host["final_norm"]),
                     device="cpu")


@pytest.mark.parametrize("name", DENSE)
def test_abstract_params_full_width(name):
    """Every dense arch at full width: the module on ``meta`` has the
    reference's shapes and dtypes (per layer, the stacked leaf's)."""
    ref = JM.abstract_params(jconfigs.get_config(name))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = tuple(p.key for p in path)
        if keys[0] == "blocks":
            for i in range(leaf.shape[0]):
                want[".".join(("blocks", str(i)) + keys[1:])] = (
                    tuple(leaf.shape[1:]), leaf.dtype.name)
        else:
            want[".".join(keys)] = (tuple(leaf.shape), leaf.dtype.name)
    module = TM.abstract_params(tconfigs.get_config(name))
    got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in module.named_parameters()}
    assert got == want
    assert all(p.device.type == "meta" for p in module.parameters())
    assert not TM.needs_frontend(tconfigs.get_config(name))


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_families_raise(name):
    cfg = tconfigs.get_config(name).reduced()
    for call in (lambda: TM.init_params(cfg, 0, device="cpu"),
                 lambda: TM.abstract_params(cfg),
                 lambda: TM.init_cache(cfg, 1, 4, device="cpu"),
                 lambda: TM.forward(cfg, None, dict(tokens=np.zeros((1, 2)))),
                 lambda: TM.decode_step(cfg, None, {}, np.zeros((1, 1)))):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 G"):
            call()
