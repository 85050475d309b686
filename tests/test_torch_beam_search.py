"""repro_torch's batched beam search over float, int8 and PQ graphs, and
its exact rerank, against repro.core.batch / repro.index.flat on the CPU.

The graph is the conftest KNN graph, built by the reference and carried
across with ``to_host`` / ``from_host``; the compressed corpora are the
reference's, carried across with ``quant.corpus_from_host``. Ids must be
equal. l2 scores are held through the squared distance they encode,
``d2 = (1 - s)^2``, to a few float32 ulps of ``|q|^2 + |x|^2``: both
packages take ``d2`` as that sum less twice the dot, so a near neighbour's
``d2`` carries the rounding of the two large terms (the reference's BLAS
product and XLA's fused multiply-adds round elsewhere than the port).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.core import batch as jbatch
from repro.core.graph import make_flat_graph as jmake
from repro.core.graph import to_host
from repro.index.flat import exact_rerank as jrerank
from repro_torch import quant as tq
from repro_torch.core import batch as tbatch
from repro_torch.core import beam_search as tbs
from repro_torch.core import graph as tgraph
from repro_torch.index.flat import exact_rerank as trerank

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

RTOL = ATOL = 1e-5
D2_ULPS = 1e-6       # ~8 float32 ulps of |q|^2 + |x|^2


def _queries(x, num=6, seed=4):
    rng = np.random.default_rng(seed)
    return (x[rng.integers(0, x.shape[0], num)]
            + rng.normal(size=(num, x.shape[1])) * 0.05).astype(np.float32)


def _assert_scores_close(got, ref, ids, qs, x, metric):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ok = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    if metric != "l2":
        np.testing.assert_allclose(got[ok], ref[ok], rtol=RTOL, atol=ATOL)
        return
    mag = ((qs * qs).sum(1)[:, None]
           + (x * x).sum(1)[np.maximum(ids, 0)]).astype(np.float64)
    got, ref, mag = got[ok], ref[ok], mag[ok]
    np.testing.assert_array_less(np.abs((1 - got) ** 2 - (1 - ref) ** 2),
                                 D2_ULPS * mag + 1e-7)


def _corpora(x, scheme):
    """(reference corpus, the port's copy on the CPU) for ``scheme``."""
    if scheme == "float":
        return x, x
    jc = jq.quantize_corpus(x, scheme, seed=2)
    host = (dict(codes=np.asarray(jc.codes), codebooks=np.asarray(jc.codebooks))
            if scheme == "pq" else
            dict(codes=np.asarray(jc.codes), scales=np.asarray(jc.scales),
                 scale_rows=jc.scale_rows))
    return jc, tq.corpus_from_host(host, device="cpu")


@pytest.mark.parametrize("scheme", ["float", "int8", "pq"])
@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_batch_beam_search_matches_reference(small_graph, small_graph_cos,
                                             clustered_data, metric, scheme):
    host = to_host(small_graph if metric == "l2" else small_graph_cos)
    x = clustered_data
    jv, tv = _corpora(x, scheme)
    jg = jmake(jv, host["neighbors"], None, host["entry"], metric)
    tg = tgraph.make_flat_graph(tv, host["neighbors"], None, host["entry"],
                                metric, device="cpu")
    qs = _queries(x)
    rid, rsc = jbatch.batch_beam_search(jg, jnp.asarray(qs), 10, 40)
    gid, gsc = tbatch.batch_beam_search(tg, torch.from_numpy(qs), 10, 40)
    np.testing.assert_array_equal(gid.numpy(), np.asarray(rid))
    _assert_scores_close(gsc.numpy(), rsc, gid.numpy(), qs, x, metric)
    # one query alone is its lane of the batch
    one = tbs.beam_search(tg, torch.from_numpy(qs[2]), 10, 40)
    assert torch.equal(one[0], gid[2]) and torch.equal(one[1], gsc[2])


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_exact_rerank_matches_reference(clustered_data, metric):
    x = clustered_data
    qs = _queries(x, num=5, seed=8)
    rng = np.random.default_rng(9)
    cand = np.stack([rng.choice(x.shape[0], 12, replace=False)
                     for _ in range(5)]).astype(np.int32)
    cand[:, 9:] = -1                       # -1 padding
    cand[3, 2:] = -1
    cand[4, :] = -1                        # an empty row
    rid, rsc = jrerank(qs, cand, x, metric)
    gid, gsc = trerank(qs, cand, x, metric, device="cpu")
    np.testing.assert_array_equal(gid, rid)
    _assert_scores_close(gsc, rsc, gid, qs, x, metric)
    assert (gid[4] == -1).all() and np.isneginf(gsc[4]).all()


@pytest.mark.parametrize("scheme", ["int8", "pq"])
def test_quantized_graph_is_level0_and_round_trips(clustered_data, small_graph,
                                                   scheme):
    host = to_host(small_graph)
    _, tc = _corpora(clustered_data, scheme)
    upper = np.zeros((1, clustered_data.shape[0], 4), np.int32)
    with pytest.raises(ValueError, match="upper HNSW levels"):
        tgraph.make_flat_graph(tc, host["neighbors"], upper, host["entry"],
                               "l2", device="cpu")
    g = tgraph.make_flat_graph(tc, host["neighbors"], None, host["entry"],
                               "l2", device="cpu")
    assert (g.size, g.dim, g.num_upper_levels) == (*clustered_data.shape, 0)
    back = tgraph.from_host(tgraph.to_host(g), device="cpu")
    assert type(back.vectors) is type(tc)
    for a, b in zip(tq.corpus_to_host(back.vectors).values(),
                    tq.corpus_to_host(tc).values()):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(back.neighbors, g.neighbors)
