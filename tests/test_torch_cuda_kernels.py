"""Every CUDA kernel of repro_torch against its plain version, on the card.

This file imports neither JAX nor the reference package, so it runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py -q

Without a card every test here skips. Tolerances: the similarity kernels
reduce in ``dot_seq``'s order, so their scores agree with the plain version
up to the metric transform's rounding (1e-5); every integer output, and the
exact int8 dots and ordered LUT sums, must be equal.
"""
import numpy as np
import pytest
import torch

from repro_torch import quant as tq
from repro_torch.core import similarity as tsim
from repro_torch.kernels import ops as tops

RTOL = ATOL = 1e-5
METRICS = ["l2", "ip", "cos"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _corpus(seed=0, n=300, d=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d))).astype(np.float32)


def _prefixes(x, B, W, seed=1):
    """Raw sorted queue prefixes: distinct ids by score desc, -1/-inf tail,
    and each lane's candidate budget."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    ids = np.full((B, W), -1, np.int32)
    scores = np.full((B, W), -np.inf, np.float32)
    for b in range(B):
        m = int(rng.integers(W // 2, W + 1))
        pick = rng.choice(n, m, replace=False)
        s = rng.normal(size=m).astype(np.float32)
        order = np.argsort(-s, kind="stable")
        ids[b, :m], scores[b, :m] = pick[order], s[order]
    return ids, scores, rng.integers(1, W + 1, B)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_kernels_match_plain_versions(cuda_device, metric):
    x = torch.from_numpy(_corpus(n=2000, d=96)).to(cuda_device)
    qs = torch.from_numpy(_corpus(3, n=16, d=96)).to(cuda_device)
    ids_np, scores_np, Ks = _prefixes(_corpus(n=2000, d=96), B=8, W=256)
    ids = torch.from_numpy(ids_np).to(cuda_device)
    scores = torch.from_numpy(scores_np).to(cuda_device)
    # eps at each lane's 0.9 quantile of pair similarity: ~10% edges
    rows = x[ids.clamp(min=0).long()]
    eps = torch.quantile(tsim.pairwise_sim(rows, rows, metric).flatten(1),
                         0.9, dim=1).contiguous()
    np.testing.assert_allclose(
        tops.batch_similarity(qs, x, metric, impl="cuda").cpu(),
        tops.batch_similarity(qs, x, metric, impl="ref").cpu(), rtol=RTOL,
        atol=ATOL)
    nb = ids.clamp(min=0)[:, :32].contiguous()
    np.testing.assert_allclose(
        tops.batch_similarity_gather(qs[:8], x, nb, metric, impl="cuda").cpu(),
        tops.batch_similarity_gather(qs[:8], x, nb, metric, impl="ref").cpu(),
        rtol=RTOL, atol=ATOL)
    adj_k = tops.pairwise_adjacency_batch(x, ids, eps, metric, impl="cuda")
    adj_r = tops.pairwise_adjacency_batch(x, ids, eps, metric, impl="ref")
    assert torch.equal(adj_k, adj_r) and bool(adj_k.any())
    valid = ids >= 0
    for k in (5, 10):
        gk = tops.greedy_diversify_batch(scores, adj_r, k, valid, impl="cuda")
        gr = tops.greedy_diversify_batch(scores, adj_r, k, valid, impl="ref")
        assert torch.equal(gk[0], gr[0]) and torch.equal(gk[1], gr[1])
        fk = tops.fused_round_batch(x, ids, scores, Ks, eps, k, metric,
                                    impl="cuda")
        fr = tops.fused_round_batch(x, ids, scores, Ks, eps, k, metric,
                                    impl="ref")
        for a, b in zip(fk[:3], fr[:3]):
            assert torch.equal(a, b)
        np.testing.assert_allclose(fk[3].cpu(), fr[3].cpu(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4096, 96), (1037, 30)])
def test_cuda_quantized_kernels_equal_plain_versions(cuda_device, n, d):
    from repro_torch.kernels.int8_similarity import int8_dot_cuda
    from repro_torch.kernels.pq_lut_similarity import pq_lut_sum_cuda
    from repro_torch.kernels.ref import int8_dot

    x = torch.from_numpy(_corpus(d, n=n, d=d)).to(cuda_device)
    qs = torch.from_numpy(_corpus(d + 1, n=16, d=d)).to(cuda_device)
    c8 = tq.quantize_corpus(x, "int8")
    qc, _ = tq.quantize_queries(qs)
    assert torch.equal(int8_dot_cuda(qc, c8.codes), int8_dot(qc, c8.codes))
    pq = tq.quantize_corpus(x, "pq", pq_m=16 if d == 96 else 5, pq_iters=3)
    for metric in METRICS:
        T, S, _ = tq.pq_luts_many(qs, pq.codebooks, metric)
        for table in (T, S[None].contiguous()):
            assert torch.equal(pq_lut_sum_cuda(table, pq.codes),
                               tq.pq_lut_sum(table, pq.codes))
        for corpus in (c8, pq):
            assert torch.equal(
                tops.quantized_similarity_many(qs, corpus, metric, impl="cuda"),
                tops.quantized_similarity_many(qs, corpus, metric, impl="ref"))
    # a code at or above C is refused, as the plain version's gather refuses it
    with pytest.raises(ValueError, match=">= C"):
        pq_lut_sum_cuda(torch.zeros((1, 2, 4), device=cuda_device),
                        torch.full((3, 2), 4, dtype=torch.uint8,
                                   device=cuda_device))
