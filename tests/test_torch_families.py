"""The other model families (moe, ssm, hybrid, encdec, vlm):
repro_torch.models against repro.models, on the CPU.

Each non-dense arch's reduced config runs in both packages on the same
parameters: the reference's ``init_params(cfg, jax.random.key(0))``
carried over by ``model.from_host``. The reference's forward and decode
step are compiled with ``xla_allow_excess_precision`` off, so that every
``.astype(bfloat16)`` of its source rounds as written. By default XLA keeps
fused bf16 intermediates in float32, which moves vlm's logits at its six
reduced blocks 4.02 bf16 ulps of the largest |logit| from the port's,
where the strict compile is 3e-5 ulps from them
(``test_port_follows_the_reference_as_written`` prints both); the dense
tests (tests/test_torch_models.py) hold the default compile at two blocks.

Tolerances, as tests/test_torch_models.py sets them: a component's bf16
output within one bf16 ulp of each value (rtol 2**-7); float32 outputs at
rtol 1e-5 (the sums' order differs); logits and caches within 4 bf16 ulps
of their largest |value| (``test_forward_matches_reference`` prints the
forward's gap: under 4e-5 for every family but ssm, whose chunked SSD
contracts its four-operand einsums in another order, 3.14); tokens compared where the reference's top-2 margin exceeds twice
that. Integer outputs are equal: the MoE's expert ids, ranks and
keep / drop mask.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b", "mamba2-370m",
         "recurrentgemma-9b", "whisper-small", "llama-3.2-vision-90b")
B, S, STEPS, MAX_SEQ = 2, 12, 8, 16
BF16_RTOL = 2.0 ** -7
LOGIT_ULPS = 4
STRICT = {"xla_allow_excess_precision": False}


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a) -> torch.Tensor:
    """A reference array as a port tensor, bits kept (bf16 included)."""
    return TM._tensor(np.asarray(a))


def _bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def bf16_tol(ref) -> float:
    top = float(np.max(np.abs(_f32(ref))))
    return LOGIT_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


def close(got, want, rtol=BF16_RTOL, atol=1e-6):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol)


def strict(fn, *args):
    """``fn`` compiled for ``args`` with every bf16 cast a rounding."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)


def assert_tokens_agree(got_logits, ref_logits, tol) -> float:
    ref = np.asarray(ref_logits, np.float32)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * tol
    np.testing.assert_array_equal(np.argmax(got_logits, -1)[sure],
                                  np.argmax(ref, -1)[sure])
    return float(np.mean(sure))


def _batch(cfg, seed=7, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    jb, tb = dict(tokens=jnp.asarray(toks)), dict(tokens=torch.from_numpy(
        toks))
    if cfg.num_frontend_tokens:
        fe = _bf16(rng.normal(size=(B, cfg.num_frontend_tokens,
                                    cfg.d_model)) * 0.5)
        jb["frontend_embeds"], tb["frontend_embeds"] = jnp.asarray(fe), _t(fe)
    return toks, jb, tb


def reference_run(cfg, params, toks, jb, steps=STEPS, max_seq=MAX_SEQ):
    """The reference's forward logits and ``steps`` decode steps (compiled
    with STRICT), and its cache after them, as numpy."""
    fwd = strict(lambda p, b: JM.forward(cfg, p, b), params, jb)
    logits, aux = fwd(params, jb)
    cache = JM.init_cache(cfg, B, max_seq)
    step = strict(functools.partial(JM.decode_step, cfg), params, cache,
                  jnp.asarray(toks[:, :1]))
    dec = []
    for t in range(steps):
        lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]))
        dec.append(np.asarray(lg[:, 0]))
    return dict(logits=np.asarray(logits), aux=float(aux),
                dec=np.stack(dec, 1), cache=jax.tree.map(np.asarray, cache))


def port_decode(tcfg, tparams, toks, steps=STEPS, max_seq=MAX_SEQ):
    cache = TM.init_cache(tcfg, B, max_seq, device="cpu")
    dec = []
    for t in range(steps):
        lg, cache = TM.decode_step(tcfg, tparams, cache,
                                   torch.from_numpy(toks[:, t:t + 1]))
        dec.append(lg[:, 0].numpy())
    return np.stack(dec, 1), cache


def _world(cfg, tcfg, seed=0):
    params = JM.init_params(cfg, jax.random.key(seed))
    host = jax.tree.map(np.asarray, params)
    toks, jb, tb = _batch(cfg)
    return dict(cfg=cfg, tcfg=tcfg, params=params, host=host, toks=toks,
                jb=jb, tb=tb, ref=reference_run(cfg, params, toks, jb),
                tparams=TM.from_host(tcfg, host, device="cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    return dict(_world(jconfigs.get_config(name).reduced(),
                       tconfigs.get_config(name).reduced()), name=name)


# ------------------------------------------------------------------ moe ---
def _ref_route(wr, xt, e, topk, cf):
    """The reference's routing (src/repro/models/moe.py:45-67), step by
    step: expert ids, ranks within the expert and the keep mask."""
    logits = jnp.dot(xt.astype(jnp.float32), wr.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, expert = jax.lax.top_k(probs, topk)
    t = xt.shape[0]
    capacity = max(1, int(t * topk * cf / e))
    flat_expert = expert.reshape(-1)
    order = jnp.argsort(flat_expert, stable=True)
    counts = jnp.bincount(flat_expert, length=e)
    starts = jnp.concatenate([jnp.zeros(1, counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    pos_sorted = jnp.arange(t * topk) - starts[flat_expert[order]]
    pos = jnp.zeros(t * topk, jnp.int32).at[order].set(
        pos_sorted.astype(jnp.int32))
    return np.asarray(expert), np.asarray(pos), np.asarray(pos < capacity)


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("tokens, cf", [(12, 1.25), (12, 0.5), (1, 1.25)])
def test_moe_ffn_matches_reference(name, tokens, cf):
    """Routing, drops and the expert FFN of one block: expert ids, ranks and
    keep mask equal; the output within a bf16 ulp, aux at 1e-6."""
    cfg = jconfigs.get_config(name).reduced()
    params = JM.init_params(cfg, jax.random.key(1))
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    tp = TM.from_host(tconfigs.get_config(name).reduced(), jax.tree.map(
        np.asarray, params), device="cpu").blocks[0].moe
    x = _bf16(np.random.default_rng(2).normal(size=(B, tokens, cfg.d_model)))
    e, k = cfg.num_experts, cfg.experts_per_token
    want = _ref_route(jp["wr"], jnp.asarray(x.reshape(-1, cfg.d_model)), e, k,
                      cf)
    _, _, expert, pos, keep, _ = TMoE.route(
        tp.wr, _t(x).reshape(-1, cfg.d_model), e, k, cf)
    np.testing.assert_array_equal(expert.numpy(), want[0])
    np.testing.assert_array_equal(pos.numpy(), want[1])
    np.testing.assert_array_equal(keep.numpy(), want[2])
    if cf < 1 or tokens == 1:
        assert not keep.all()             # these shapes drop pairs
    jy, jaux = JMoE.moe_ffn(jp, jnp.asarray(x), num_experts=e,
                            experts_per_token=k, capacity_factor=cf,
                            act=cfg.mlp_act)
    ty, taux = TMoE.moe_ffn(tp, _t(x), num_experts=e, experts_per_token=k,
                            capacity_factor=cf, act=cfg.mlp_act)
    assert ty.dtype == torch.bfloat16 and ty.shape == x.shape
    close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_moe_top_k_ties_take_the_lower_expert():
    """Equal router probabilities pick the lower expert id first, as
    ``lax.top_k`` does; ranks follow token order."""
    wr = torch.zeros((4, 6))
    xt = torch.ones((3, 4))
    probs, gate, expert, pos, keep, cap = TMoE.route(wr, xt, 6, 2, 1.0)
    assert expert.tolist() == [[0, 1]] * 3
    assert pos.tolist() == [0, 0, 1, 1, 2, 2] and cap == 1
    assert keep.tolist() == [True, True, False, False, False, False]
    torch.testing.assert_close(gate, torch.full((3, 2), 0.5))


# ------------------------------------------------------------ components ---
def test_layer_norm_and_sinusoids_match_reference():
    rng = np.random.default_rng(3)
    x = _bf16(rng.normal(size=(B, 7, 64)) * 3 + 1)
    scale = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    bias = (0.1 * rng.normal(size=64)).astype(np.float32)
    close(TL.layer_norm(_t(x), _t(scale), _t(bias)),
          JL.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    for length, ch in ((12, 64), (1500, 768)):
        # angles up to ``length`` radians: an ulp of the angle (the two
        # packages' float32 exp may differ by one) moves sin / cos by up to
        # 2**-23 * length
        np.testing.assert_allclose(TE.sinusoids(length, ch).numpy(),
                                   np.asarray(JE.sinusoids(length, ch)),
                                   rtol=0, atol=2.0 ** -22 * length)


def test_causal_conv_and_ssd_match_reference():
    rng = np.random.default_rng(4)
    x = _bf16(rng.normal(size=(B, 11, 40)))
    w = _bf16(rng.normal(size=(4, 40)) * 0.3)
    bias = _bf16(rng.normal(size=40) * 0.1)
    close(TS._causal_conv(_t(x), _t(w), _t(bias)),
          JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias)))
    h, p, n, s = 3, 8, 5, 13
    xh = rng.normal(size=(B, s, h, p)).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, s, h))).astype(np.float32) * 0.5
    a = -np.exp(rng.normal(size=h)).astype(np.float32)
    b_, c_ = (rng.normal(size=(B, s, n)).astype(np.float32) for _ in "bc")
    for chunk in (4, 5, 13, 64):        # padded, exact and one-chunk
        jy, jh = JS.ssd_chunked(*map(jnp.asarray, (xh, dt, a, b_, c_)),
                                chunk=chunk)
        ty, th = TS.ssd_chunked(*map(torch.from_numpy, (xh, dt, a, b_, c_)),
                                chunk=chunk)
        close(ty, jy, rtol=1e-5, atol=1e-5)
        close(th, jh, rtol=1e-5, atol=1e-5)
    h0 = rng.normal(size=(B, h, p, n)).astype(np.float32)
    for t in range(3):
        args = (xh[:, t:t + 1], dt[:, t:t + 1], a, b_[:, t:t + 1],
                c_[:, t:t + 1], h0)
        jy, jh = JS.ssd_step(*map(jnp.asarray, args))
        ty, th = TS.ssd_step(*map(torch.from_numpy, args))
        close(ty, jy, rtol=1e-5, atol=1e-6)
        close(th, jh, rtol=1e-5, atol=1e-6)
        h0 = np.array(jh)
    # the chunked scan's last state continues the step by step one
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (xh, dt, a, b_, c_)), chunk=4)
    th = torch.zeros((B, h, p, n))
    for t in range(s):
        _, th = TS.ssd_step(*map(torch.from_numpy, (
            xh[:, t:t + 1], dt[:, t:t + 1], a, b_[:, t:t + 1],
            c_[:, t:t + 1])), th)
    close(th, jh, rtol=1e-4, atol=1e-5)


def test_rg_lru_matches_reference():
    """The sequential scan against the reference's associative scan (the
    same values in another float order: rtol 1e-5) and the step."""
    cfg = jconfigs.get_config("recurrentgemma-9b").reduced()
    params = JM.init_params(cfg, jax.random.key(5))
    tp = TM.from_host(tconfigs.get_config("recurrentgemma-9b").reduced(),
                      jax.tree.map(np.asarray, params), device="cpu")
    jlru = jax.tree.map(lambda a: a[0], params["blocks"]["b0"]["lru"])
    tlru = tp.blocks[0].b0.lru
    rng = np.random.default_rng(6)
    x = _bf16(rng.normal(size=(B, 9, 64)))
    jy, jh = JR.rg_lru(jlru, jnp.asarray(x))
    ty, th = TR.rg_lru(tlru, _t(x))
    close(ty, jy)
    close(th, jh, rtol=1e-5, atol=1e-6)
    h = rng.normal(size=(B, 64)).astype(np.float32)
    jy, jh = JR.rg_lru_step(jlru, jnp.asarray(x[:, :1]), jnp.asarray(h))
    ty, th = TR.rg_lru_step(tlru, _t(x[:, :1]), torch.from_numpy(h))
    close(ty, jy)
    close(th, jh, rtol=1e-5, atol=1e-6)
    jblk = jax.tree.map(lambda a: a[0], params["blocks"]["b0"])
    jo, jst = JR.recurrent_block(jblk, jnp.asarray(x))
    to, tst = TR.recurrent_block(tp.blocks[0].b0, _t(x))
    close(to, jo)
    close(tst, jst, rtol=1e-5, atol=1e-6)


def test_attention_windows_match_reference():
    """Non-causal prefill attention, windows with and without a query
    offset, against ``flash_attention``."""
    rng = np.random.default_rng(8)
    q = _bf16(rng.normal(size=(B, 10, 4, 16)))
    k, v = (_bf16(rng.normal(size=(B, 14, 2, 16))) for _ in "kv")
    for kw in (dict(causal=False), dict(causal=False, window=3),
               dict(window=4, q_offset=4), dict(window=1)):
        close(TL.attention(_t(q), _t(k), _t(v), **kw),
              JL.flash_attention(*map(jnp.asarray, (q, k, v)), **kw))


@pytest.mark.parametrize("size", [4, 8, 16])
def test_ring_window_decode_past_its_wrap(size):
    """The local-window block's decode (``_self_attn`` with ``window=6``)
    into a cache of ``size`` rows for 11 steps: rows written at
    cache_len mod size, the ``size <= window`` branch (every written row
    counts) at 4, the windowed branch at 8 and 16."""
    cfg = jconfigs.get_config("recurrentgemma-9b").reduced()
    tcfg = tconfigs.get_config("recurrentgemma-9b").reduced()
    params = JM.init_params(cfg, jax.random.key(9))
    jblk = jax.tree.map(lambda a: a[0], params["blocks"]["b2"])
    tblk = TM.from_host(tcfg, jax.tree.map(np.asarray, params),
                        device="cpu").blocks[0].b2
    rng = np.random.default_rng(10)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    jk = jv = jnp.zeros((B, size, kv, hd), jnp.bfloat16)
    tk, tv = torch.zeros((2, B, size, kv, hd), dtype=torch.bfloat16)
    for t in range(11):
        x = _bf16(rng.normal(size=(B, 1, cfg.d_model)))
        cl = np.full(B, t, np.int32)
        jo, (jk, jv) = JT._self_attn(jblk, jnp.asarray(x), jnp.asarray(
            cl[:, None]), cfg, window=6, decode=(jk, jv, jnp.asarray(cl)))
        to = TT._self_attn(tblk, _t(x), torch.from_numpy(cl[:, None]), tcfg,
                           window=6, decode=(tk, tv, torch.from_numpy(cl)))
        close(to, jo)
        close(tk, jk)
        close(tv, jv)


# ---------------------------------------------------------- whole models ---
def test_forward_matches_reference(arch):
    cfg = arch["cfg"]
    logits, aux = TM.forward(arch["tcfg"], arch["tparams"], arch["tb"])
    assert logits.dtype == torch.float32
    assert logits.shape == (B, S, cfg.vocab_size)
    ref = arch["ref"]["logits"]
    tol = bf16_tol(ref)
    print(f"{arch['name']}: forward within "
          f"{np.max(np.abs(logits.numpy() - ref)) / (tol / LOGIT_ULPS):.3g} "
          "bf16 ulps of the largest |logit|")
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=tol)
    assert assert_tokens_agree(logits.numpy(), ref, tol) > 0
    if cfg.family == "moe":
        np.testing.assert_allclose(float(aux), arch["ref"]["aux"], rtol=1e-5)
    else:
        assert aux == 0.0


def test_decode_steps_match_reference(arch):
    """8 decode steps: logits, every cache tensor and cache_len."""
    dec, cache = port_decode(arch["tcfg"], arch["tparams"], arch["toks"])
    ref = arch["ref"]
    tol = bf16_tol(ref["dec"])
    np.testing.assert_allclose(dec, ref["dec"], rtol=0, atol=tol)
    assert assert_tokens_agree(dec, ref["dec"], tol) > 0
    assert set(cache) == set(ref["cache"])
    for key, want in ref["cache"].items():
        got = cache[key]
        assert tuple(got.shape) == want.shape, key
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, key
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(got.numpy(), want)
        elif want.size and np.abs(_f32(want)).max() > 0:
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                                       atol=bf16_tol(want))
        else:
            assert not _f32(got).any(), key     # the untouched cross cache


def test_host_round_trip_is_bit_exact(arch):
    host = arch["host"]
    back = TM.to_host(arch["tparams"])
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert not any(p.requires_grad for p in arch["tparams"].parameters())
    first = next(iter(host))
    with pytest.raises(ValueError, match="do not fit"):
        TM.from_host(arch["tcfg"], dict(host, extra=host[first]),
                     device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        TM.from_host(arch["tcfg"], {k: v for k, v in host.items()
                                    if k != first}, device="cpu")
    # a leaf of the wrong shape inside a stack
    leaves, treedef = jax.tree.flatten(host)
    i = next(i for i, a in enumerate(leaves)
             if a.ndim >= 2 and a.shape[-1] > 1)
    leaves[i] = leaves[i][..., :1]
    with pytest.raises(ValueError, match="expected"):
        TM.from_host(arch["tcfg"], jax.tree.unflatten(treedef, leaves),
                     device="cpu")


def test_hybrid_tail_blocks_match_reference():
    """recurrentgemma's depth past its last whole pattern: 5 layers are one
    RRA superblock and ``tail0``, ``tail1`` (both R), with their
    ``tail{i}_conv`` / ``tail{i}_h`` cache entries."""
    name = "recurrentgemma-9b"
    cfg = dataclasses.replace(jconfigs.get_config(name).reduced(),
                              num_layers=5)
    tcfg = dataclasses.replace(tconfigs.get_config(name).reduced(),
                               num_layers=5)
    w = _world(cfg, tcfg, seed=11)
    assert {"tail0", "tail1"} <= set(w["host"])
    back = TM.to_host(w["tparams"])
    for a, b in zip(jax.tree.leaves(w["host"]), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    logits, _ = TM.forward(tcfg, w["tparams"], w["tb"])
    tol = bf16_tol(w["ref"]["logits"])
    np.testing.assert_allclose(logits.numpy(), w["ref"]["logits"], rtol=0,
                               atol=tol)
    dec, cache = port_decode(tcfg, w["tparams"], w["toks"])
    np.testing.assert_allclose(dec, w["ref"]["dec"], rtol=0,
                               atol=bf16_tol(w["ref"]["dec"]))
    for key in ("tail0_conv", "tail0_h", "tail1_conv", "tail1_h"):
        want = w["ref"]["cache"][key]
        np.testing.assert_allclose(_f32(cache[key]), _f32(want), rtol=0,
                                   atol=bf16_tol(want))


def test_encode_matches_reference():
    cfg = jconfigs.get_config("whisper-small").reduced()
    tcfg = tconfigs.get_config("whisper-small").reduced()
    params = JM.init_params(cfg, jax.random.key(12))
    tp = TM.from_host(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    frames = _bf16(np.random.default_rng(12).normal(size=(B, 12, 64)))
    want = strict(lambda p, f: JE.encode(cfg, p, f), params,
                  jnp.asarray(frames))(params, jnp.asarray(frames))
    got = TE.encode(tcfg, tp, _t(frames))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=bf16_tol(want))


def test_vlm_needs_frontend_embeds():
    tcfg = tconfigs.get_config("llama-3.2-vision-90b").reduced()
    params = TM.init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="frontend_embeds"):
        TM.forward(tcfg, params, dict(tokens=np.zeros((1, 2), np.int64)))
    assert TM.needs_frontend(tcfg)


@pytest.mark.parametrize("name", ARCHS)
def test_float32_decode_matches_forward(name):
    """In float32 the port's decode equals its own forward (rtol = atol =
    2e-3, as tests/test_models.py holds the reference's): moe with room
    for every pair (capacity_factor = E / topk), encdec with its cross
    cache filled from the encoder's output."""
    tcfg = dataclasses.replace(tconfigs.get_config(name).reduced(),
                               dtype="float32")
    if tcfg.family == "moe":
        tcfg = dataclasses.replace(tcfg, capacity_factor=(
            tcfg.num_experts / tcfg.experts_per_token))
    params = TM.init_params(tcfg, 13, device="cpu")
    for blk in getattr(params, "cross_blocks", ()):
        blk.gate.fill_(0.5)
    toks, _, tb = _batch(tcfg, seed=14, s=9)
    if "frontend_embeds" in tb:
        tb["frontend_embeds"] = tb["frontend_embeds"].float()
    full, _ = TM.forward(tcfg, params, tb)
    cache = TM.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    if tcfg.family == "encdec":
        enc = TE.encode(tcfg, params, tb["frontend_embeds"])
        kv, hd = tcfg.num_kv_heads, tcfg.resolved_head_dim
        for i, p in enumerate(params.dec_blocks):
            cache["cross_k"][i] = TE._project(p.cross_attn.wk,
                                              p.cross_attn.bk, enc, kv, hd)
            cache["cross_v"][i] = TE._project(p.cross_attn.wv,
                                              p.cross_attn.bv, enc, kv, hd)
    elif tcfg.family == "vlm":
        # the forward's cross k / v, as the decode cache holds them
        kv, hd = tcfg.num_kv_heads, tcfg.resolved_head_dim
        fe = tb["frontend_embeds"]
        for s, blk in enumerate(params.cross_blocks):
            cache["cross_k"][s] = TL.dot_f32(fe, blk.attn.wk).reshape(
                B, -1, kv, hd)
            cache["cross_v"][s] = TL.dot_f32(fe, blk.attn.wv).reshape(
                B, -1, kv, hd)
    dec = []
    for t in range(toks.shape[1]):
        lg, cache = TM.decode_step(tcfg, params, cache, toks[:, t:t + 1])
        dec.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_port_follows_the_reference_as_written():
    """vlm's six reduced blocks: the port's logits within 0.01 bf16 ulps of
    the largest |logit| of the reference compiled with every bf16 cast a
    rounding (STRICT). Printed beside it: the gap to XLA's default compile,
    which keeps fused bf16 intermediates in float32 (4.02 ulps on this
    machine's JAX 0.9.0)."""
    name = "llama-3.2-vision-90b"
    w = _world(jconfigs.get_config(name).reduced(),
               tconfigs.get_config(name).reduced())
    got, _ = TM.forward(w["tcfg"], w["tparams"], w["tb"])
    default, _ = JM.forward(w["cfg"], w["params"], w["jb"])
    ulp = bf16_tol(w["ref"]["logits"]) / LOGIT_ULPS
    strict_gap = float(np.max(np.abs(got.numpy() - w["ref"]["logits"])))
    default_gap = float(np.max(np.abs(got.numpy() - np.asarray(default))))
    print(f"port against the strict compile {strict_gap / ulp:.2e} ulps, "
          f"against the default compile {default_gap / ulp:.2f} ulps")
    assert strict_gap <= 0.01 * ulp
