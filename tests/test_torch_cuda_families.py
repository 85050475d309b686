"""The other model families on the card against the CPU, with no JAX
needed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_families.py -q

Without a card every test here skips. Each non-dense arch's reduced
decoder is drawn once on the CPU and copied to the card, so both devices
run the same weights. vlm's cross gates are set to 0.5 and encdec's and
vlm's cross caches filled with the same seeded values on both devices, so
the cross-attention contributes (at their zero init it adds exactly 0).
The card's bf16 products accumulate in float32 through cuBLAS (``torch.mm``
/ ``torch.bmm`` with ``out_dtype``), the CPU's through float32 upcasts, so
a bf16 rounding may fall on either side: logits are held to 4 bf16 ulps of
the largest |logit|, tokens compared where the CPU's top-2 margin exceeds
twice that. The MoE's routing must be identical on both devices, and its
output on the card the same bits in two runs (no atomics in its sums).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import moe

pytestmark = pytest.mark.cuda

ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b", "mamba2-370m",
         "recurrentgemma-9b", "whisper-small", "llama-3.2-vision-90b")
B, S, STEPS = 3, 10, 4


def bf16_tol(ref: np.ndarray) -> float:
    top = float(np.max(np.abs(ref)))
    return 4 * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _models(name, device):
    cfg = get_config(name).reduced()
    cpu = M.init_params(cfg, 0, device="cpu")
    for blk in getattr(cpu, "cross_blocks", ()):
        blk.gate.fill_(0.5)
    return cfg, cpu, M.from_host(cfg, M.to_host(cpu), device=device)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    fe = None
    if cfg.num_frontend_tokens:
        fe = torch.from_numpy(rng.normal(size=(
            B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
            * 0.5).to(torch.bfloat16)
    return toks, fe


def _run(cfg, params, toks, fe, device):
    batch = dict(tokens=torch.as_tensor(toks, device=device))
    if fe is not None:
        batch["frontend_embeds"] = fe.to(device)
    full, _ = M.forward(cfg, params, batch)
    cache = M.init_cache(cfg, B, S, device=device)
    for key in ("cross_k", "cross_v"):
        if key in cache:
            gen = torch.Generator().manual_seed(1 + (key == "cross_v"))
            cache[key].copy_(torch.randn(cache[key].shape, generator=gen)
                             .to(cache[key].dtype))
    dec = []
    for t in range(STEPS):
        lg, cache = M.decode_step(cfg, params, cache,
                                  torch.as_tensor(toks[:, t:t + 1]))
        dec.append(lg[:, 0].cpu().numpy())
    return full.cpu().numpy(), np.stack(dec, 1), cache


@pytest.mark.parametrize("name", ARCHS)
def test_cuda_family_equals_cpu(cuda_device, name):
    """forward and 4 decode steps, the card against the plain CPU."""
    cfg, cpu, card = _models(name, cuda_device)
    toks, fe = _inputs(cfg)
    wfull, wdec, wcache = _run(cfg, cpu, toks, fe, "cpu")
    gfull, gdec, gcache = _run(cfg, card, toks, fe, cuda_device)
    assert np.isfinite(gfull).all() and np.isfinite(gdec).all()
    for got, want in ((gfull, wfull), (gdec, wdec)):
        tol = bf16_tol(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        top2 = np.sort(want, -1)[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) > 2 * tol
        assert sure.any()
        np.testing.assert_array_equal(got.argmax(-1)[sure],
                                      want.argmax(-1)[sure])
    assert set(gcache) == set(wcache)
    for key, want in wcache.items():
        got = gcache[key]
        assert got.device.type == cuda_device.type, key
        assert got.dtype == want.dtype, key
        if want.dtype == torch.int32:
            assert torch.equal(got.cpu(), want), key
        else:
            w = want.float().numpy()
            np.testing.assert_allclose(got.float().cpu().numpy(), w, rtol=0,
                                       atol=bf16_tol(w) if w.any() else 0)


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_cuda_moe_dispatch_is_deterministic(cuda_device, name):
    """The MoE FFN with drops on the card: routing equal to the CPU's and
    the same output bits in two runs."""
    cfg, cpu, card = _models(name, cuda_device)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 16, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    kw = dict(num_experts=cfg.num_experts,
              experts_per_token=cfg.experts_per_token, capacity_factor=0.5,
              act=cfg.mlp_act)
    blk_cpu, blk = cpu.blocks[0].moe, card.blocks[0].moe
    want = moe.route(blk_cpu.wr, x.reshape(-1, cfg.d_model),
                     cfg.num_experts, cfg.experts_per_token, 0.5)
    got = moe.route(blk.wr, x.reshape(-1, cfg.d_model).to(cuda_device),
                    cfg.num_experts, cfg.experts_per_token, 0.5)
    for g, w in zip(got[2:5], want[2:5]):      # expert, pos, keep
        assert torch.equal(g.cpu(), w)
    assert not want[4].all()
    y1, a1 = moe.moe_ffn(blk, x.to(cuda_device), **kw)
    y2, a2 = moe.moe_ffn(blk, x.to(cuda_device), **kw)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    yc, _ = moe.moe_ffn(blk_cpu, x, **kw)
    np.testing.assert_allclose(y1.float().cpu().numpy(), yc.float().numpy(),
                               rtol=2.0 ** -7, atol=1e-6)
