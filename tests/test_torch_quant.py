"""repro_torch.quant and the quantized scorers against repro.quant and
repro.kernels.ops at impl="ref", on the CPU (the int8_dot and pq_lut_sum
kernels are held against their plain versions in
``test_torch_cuda_kernels.py``).

Exact by construction, so held bit for bit: int8 codes, scales, query
codes and dots; the LUT sum on the same tables; int8 ip/cos scores. Held at
a tolerance: PQ tables (the port adds each subspace's products in one fixed
order, XLA contracts them its own way, so entries can differ in the last
bit) and int8 l2 scores (XLA on the CPU fuses ``q2 + x2`` into a multiply-add
in its vectorized loop, not in the loop's tail).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.kernels import ops as jops
from repro_torch import quant as tq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

RTOL = ATOL = 1e-5
METRICS = ["l2", "ip", "cos"]
SCHEMES = ["int8", "pq"]
WIDTHS = [24, 30]
N = 517          # not a multiple of 3 or 8: the last int8 scale block is short


def _data(d, seed=0):
    rng = np.random.default_rng(seed + d)
    centers = rng.normal(size=(16, d))
    x = (centers[rng.integers(0, 16, N)] + rng.normal(size=(N, d)) * 0.5)
    qs = x[rng.integers(0, N, 5)] + rng.normal(size=(5, d)) * 0.1
    return x.astype(np.float32), qs.astype(np.float32)


def _host(corpus) -> dict:
    """A reference corpus as the numpy dict ``corpus_from_host`` reads."""
    if isinstance(corpus, jq.PQCorpus):
        return dict(codes=np.asarray(corpus.codes),
                    codebooks=np.asarray(corpus.codebooks))
    return dict(codes=np.asarray(corpus.codes),
                scales=np.asarray(corpus.scales),
                scale_rows=corpus.scale_rows)


@pytest.fixture(scope="module")
def corpora():
    """Per width: data, queries, and each scheme's reference corpus with
    its copy in the port (carried across with ``corpus_from_host``)."""
    out = {}
    for d in WIDTHS:
        x, qs = _data(d)
        for scheme in SCHEMES:
            jc = jq.quantize_corpus(x, scheme, seed=5)
            out[d, scheme] = (x, qs, jc,
                              tq.corpus_from_host(_host(jc), device="cpu"))
    return out


@pytest.mark.parametrize("scale_rows", [1, 3, 8])
@pytest.mark.parametrize("d", WIDTHS)
def test_int8_codes_and_scales_equal_reference(d, scale_rows):
    x, _ = _data(d)
    ref = jq.quantize_int8(x, scale_rows=scale_rows)
    got = tq.quantize_int8(x, scale_rows=scale_rows, device="cpu")
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
    np.testing.assert_array_equal(got.row_scales().numpy(),
                                  np.asarray(ref.row_scales()))
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(ref.dequantize()))


def test_block_quantizer_matches_reference():
    flat = _data(24)[0].ravel()[:5000] * 3.0       # not a whole block
    rb, rn = jq.block_view(jnp.asarray(flat))
    gb, gn = tq.block_view(torch.from_numpy(flat))
    assert gn == rn == 5000
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    scale = np.float32(0.013)
    np.testing.assert_array_equal(
        tq.quantize_blocks(gb, torch.tensor(scale)).numpy(),
        np.asarray(jq.quantize_blocks(rb, scale)))


@pytest.mark.parametrize("d", WIDTHS)
def test_query_codes_and_int8_dots_equal_reference(d):
    x, qs = _data(d)
    # the reference quantizes queries under jit only (its ops are jitted)
    rc, rs = jax.jit(jq.quantize_queries)(jnp.asarray(qs))
    gc, gs = tq.quantize_queries(torch.from_numpy(qs))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    xc = jq.quantize_int8(x).codes
    ref = jnp.einsum("bd,nd->bn", rc.astype(jnp.int32), xc.astype(jnp.int32))
    got = tref.int8_dot(gc, torch.from_numpy(np.array(xc)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("d", WIDTHS)
def test_quantized_similarity_many_matches_reference(corpora, d, scheme,
                                                     metric):
    x, qs, jc, tc = corpora[d, scheme]
    ref = np.asarray(jops.quantized_similarity_many(jnp.asarray(qs), jc,
                                                    metric, impl="ref"))
    got = tops.quantized_similarity_many(torch.from_numpy(qs), tc,
                                         metric).numpy()
    assert got.shape == (qs.shape[0], N)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if scheme == "int8" and metric in ("ip", "cos"):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("metric", METRICS)
def test_pq_lut_sum_bitwise_on_the_same_tables(corpora, metric):
    """Fed the reference's own tables, the port's sum is the reference's,
    bit for bit: both add subspace by subspace from m = 0."""
    _, qs, jc, tc = corpora[24, "pq"]
    T, S, qn = jq.pq_luts_many(jnp.asarray(qs), jc.codebooks, metric)
    for table in (T, S):
        ref = np.asarray(jq.pq_lut_sum(table, jc.codes))
        got = tq.pq_lut_sum(torch.from_numpy(np.array(table)), tc.codes)
        np.testing.assert_array_equal(got.numpy(), ref)
    gT, gS, gqn = tq.pq_luts_many(torch.from_numpy(qs), tc.codebooks, metric)
    for g, r in ((gT, T), (gS, S), (gqn, qn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("d", WIDTHS)
def test_train_pq_matches_reference(d):
    """Same seed, same sample and initial centroids (one numpy Generator in
    the reference's call order). The Lloyd steps sum clusters in float64
    where the reference adds float32 rows in turn, so centroids agree to a
    few ulps; a code may differ only where the reference's own distances to
    the two centroids tie within 1e-5 (none do at these seeds)."""
    x, _ = _data(d, seed=7)
    ref = jq.quantize_corpus(x, "pq", seed=9, pq_iters=6)
    got = tq.quantize_corpus(x, "pq", seed=9, pq_iters=6, device="cpu")
    cbs = np.array(ref.codebooks)
    np.testing.assert_allclose(got.codebooks.numpy(), cbs, rtol=1e-6,
                               atol=1e-6)
    rc, gc = np.asarray(ref.codes), got.codes.numpy()
    ds = d // cbs.shape[0]
    for r, j in np.argwhere(rc != gc):
        sub = x[r, j * ds:(j + 1) * ds]
        d2 = ((cbs[j] - sub) ** 2).sum(-1)
        assert abs(d2[rc[r, j]] - d2[gc[r, j]]) <= 1e-5 * max(d2[rc[r, j]], 1)
    assert (rc != gc).mean() <= 0.005
    # encoding the reference's codebooks gives the reference's codes
    np.testing.assert_array_equal(
        tq.pq_encode(x, torch.from_numpy(cbs)).numpy(),
        np.asarray(jq.pq_encode(x, cbs)))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_score_rows_matches_batched_op(corpora, scheme, metric):
    """The beam loop's block scorer re-scores the rows the batched op
    scored (rtol 1e-6, as the reference's own test holds it), one query at
    a time and with a lane axis alike."""
    _, qs, _, tc = corpora[24, scheme]
    q = torch.from_numpy(qs)
    full = tops.quantized_similarity_many(q, tc, metric)
    idx = torch.from_numpy(np.random.default_rng(13).integers(
        0, N, (qs.shape[0], 37)).astype(np.int32))
    lanes = tq.score_rows(tq.prepare_query(tc, q, metric), tc, idx, metric)
    for r in range(qs.shape[0]):
        one = tq.score_rows(tq.prepare_query(tc, q[r], metric), tc, idx[r],
                            metric)
        np.testing.assert_allclose(one.numpy(), full[r, idx[r].long()].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(lanes[r].numpy(), one.numpy())


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bytes_per_vector_and_host_carrier_match_reference(corpora, scheme):
    x, _, jc, tc = corpora[30, scheme]
    assert tc.bytes_per_vector() == jc.bytes_per_vector()
    assert tc.code_bytes_per_vector() == jc.code_bytes_per_vector()
    assert tq.corpus_bytes_per_vector(tc) == jq.corpus_bytes_per_vector(jc)
    assert (tq.corpus_bytes_per_vector(torch.from_numpy(x))
            == jq.corpus_bytes_per_vector(x) == 4.0 * x.shape[1])
    assert tc.shape == jc.shape
    back = tq.corpus_to_host(tc)
    for key, value in _host(jc).items():
        np.testing.assert_array_equal(back[key], value)
    np.testing.assert_array_equal(tc.dequantize().numpy(),
                                  np.asarray(jc.dequantize()))


@pytest.mark.parametrize("use", ["pq_lut_sum", "dequantize", "score_rows"])
def test_uint8_codes_index_as_indices_not_masks(use):
    """torch reads a uint8 index tensor as a boolean mask: codes of 0 and 1
    would pick rows instead of indexing them. Every gather by code casts."""
    rng = np.random.default_rng(3)
    M, C, ds = 3, 4, 2
    codes = rng.integers(0, 2, (6, M)).astype(np.uint8)   # 0/1 only
    codes[0] = [1, 0, 1]
    cbs = rng.normal(size=(M, C, ds)).astype(np.float32)
    corpus = tq.PQCorpus(torch.from_numpy(codes), torch.from_numpy(cbs))
    want = np.concatenate([cbs[j, codes[:, j].astype(np.int64)]
                           for j in range(M)], axis=1)     # [6, M * ds]
    q = torch.from_numpy(rng.normal(size=M * ds).astype(np.float32))
    if use == "pq_lut_sum":
        T = torch.from_numpy(rng.normal(size=(M, C)).astype(np.float32))
        got = tq.pq_lut_sum(T, corpus.codes).numpy()
        ref = sum(T.numpy()[j, codes[:, j].astype(np.int64)] for j in range(M))
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    elif use == "dequantize":
        np.testing.assert_array_equal(corpus.dequantize().numpy(), want)
    else:
        got = tq.score_rows(tq.prepare_query(corpus, q, "ip"), corpus,
                            torch.arange(6), "ip").numpy()
        np.testing.assert_allclose(got, want @ q.numpy(), rtol=1e-5)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_cuda_rung_raises_on_a_cpu_tensor(corpora, scheme):
    _, qs, _, tc = corpora[24, scheme]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.quantized_similarity_many(torch.from_numpy(qs), tc, "l2",
                                       impl="cuda")
    with pytest.raises(TypeError):
        tops.quantized_similarity_many(torch.from_numpy(qs),
                                       torch.from_numpy(qs), "l2")
    tops.reset_launch_counts()
    tops.quantized_similarity_many(torch.from_numpy(qs), tc, "l2")
    assert sum(tops.launch_counts().values()) == 0
