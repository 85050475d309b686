"""The RAG serving path on the card against the CPU, with no JAX needed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_rag.py -q

Without a card every test here skips. The decoder's parameters are drawn
once on the CPU and copied to the card, so both devices run the same
weights; the card's bf16 products go through cuBLAS with a float32
accumulator, the CPU's through float32 upcasts, so a bf16 rounding may
fall on either side: logits are held to 4 bf16 ulps of the largest
|logit|, tokens compared where the CPU's top-2 margin exceeds twice that.
Retrieval is exact on both devices (the similarity kernels equal their
plain versions bit for bit, tests/test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.graph import to_device
from repro_torch.db import DiverseVectorDB
from repro_torch.index.flat import build_knn_graph
from repro_torch.models import model as M
from repro_torch.serve.rag import RagPipeline

pytestmark = pytest.mark.cuda

ARCH, B, S, STEPS = "qwen2-1.5b", 3, 10, 6


def bf16_tol(ref: np.ndarray) -> float:
    top = float(np.max(np.abs(ref)))
    return 4 * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(cuda_device):
    cfg = get_config(ARCH).reduced()
    cpu = M.init_params(cfg, 0, device="cpu")
    card = M.from_host(cfg, M.to_host(cpu), device=cuda_device)
    return cfg, cpu, card


def _decode(cfg, params, toks, device):
    cache = M.init_cache(cfg, toks.shape[0], toks.shape[1], device=device)
    out = []
    for t in range(toks.shape[1]):
        lg, cache = M.decode_step(cfg, params, cache,
                                  torch.as_tensor(toks[:, t:t + 1]))
        out.append(lg[:, 0].cpu().numpy())
    return np.stack(out, 1), cache


def test_cuda_decoder_equals_cpu(model, cuda_device):
    cfg, cpu, card = model
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    want, wcache = _decode(cfg, cpu, toks, "cpu")
    got, gcache = _decode(cfg, card, toks, cuda_device)
    tol = bf16_tol(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert torch.equal(gcache["cache_len"].cpu(), wcache["cache_len"])
    full, _ = M.forward(cfg, card, dict(tokens=torch.as_tensor(toks)))
    assert full.device.type == cuda_device.type
    assert full.dtype == torch.float32
    np.testing.assert_allclose(full.cpu().numpy(), want, rtol=0, atol=tol)
    top2 = np.sort(want, -1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * tol
    assert sure.any()
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


def test_cuda_generate_equals_cpu(model, cuda_device):
    cfg, cpu, card = model
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(12, 24)) * 2.0
    x = (centers[rng.integers(0, 12, 1500)]
         + rng.normal(size=(1500, 24)) * 0.3).astype(np.float32)
    graph = build_knn_graph(x, "l2", M=8, device="cpu")
    qs = x[:B] + 0.05
    prompts = rng.integers(0, cfg.vocab_size, (B, 4)).astype(np.int32)
    out = []
    for where, params in ((torch.device("cpu"), cpu), (cuda_device, card)):
        db = DiverseVectorDB(index=to_device(graph, where), num_lanes=4,
                             default_ef=8, prewarm=False, device=where)
        pipe = RagPipeline(cfg, params, db=db, k=4, eps=0.0, ef=8)
        out.append(pipe.generate(qs, prompts, steps=STEPS))
    (wtok, wids, wcert), (ttok, tids, tcert) = out
    np.testing.assert_array_equal(tids, wids)
    np.testing.assert_array_equal(tcert, wcert)
    assert (tids >= 0).all()
    # free-running tokens: equal up to the first near-tie on the CPU
    seq = np.concatenate([wids % cfg.vocab_size, prompts, wtok], 1)
    want, _ = _decode(cfg, cpu, seq, "cpu")
    gen = want[:, -STEPS - 1:-1]
    tol = bf16_tol(want)
    top2 = np.sort(gen, -1)[..., -2:]
    prefix = np.cumprod((top2[..., 1] - top2[..., 0]) > 2 * tol,
                        axis=1).astype(bool)
    np.testing.assert_array_equal(ttok[prefix], wtok[prefix])


def test_cuda_full_width_decode_step(cuda_device):
    """qwen2-1.5b at full width on the card: 1 543 714 304 parameters,
    all bf16 but the 87 552 float32 norm offsets (the reference's
    abstract_params count), and one finite decode step."""
    cfg = get_config(ARCH)
    params = M.init_params(cfg, 0, device=cuda_device)
    count = {}
    for p in params.parameters():
        count[p.dtype] = count.get(p.dtype, 0) + p.numel()
    assert count == {torch.bfloat16: 1_543_626_752, torch.float32: 87_552}
    cache = M.init_cache(cfg, 2, 8, device=cuda_device)
    logits, cache = M.decode_step(cfg, params, cache,
                                  torch.tensor([[1], [2]], device=cuda_device))
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert logits.dtype == torch.float32 and bool(logits.isfinite().all())
    assert cache["cache_len"].tolist() == [1, 1]
    del params, cache
    torch.cuda.empty_cache()
