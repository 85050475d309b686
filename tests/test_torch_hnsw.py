"""The paper's index: repro_torch.index.hnsw against repro.index.hnsw, and
the port's search stack over a real HNSW graph (upper levels, ``descend``)
against the reference's on the same graph, on the CPU with the reference
at impl="ref".

The builder's arrays (``neighbors``, ``upper``, ``entry``, ``levels``) must
be equal bit for bit. Engine ids, counts and every SearchStats field must
be equal; scores may differ by rtol = atol = 1e-5 and totals by 1e-4.
Inside the port, per-query PSS must equal the batched engine bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import batch_progressive as jbp
from repro.core import graph as jgraph
from repro.index import hnsw as jhnsw
from repro_torch.core import api as tapi
from repro_torch.core import batch_progressive as tbp
from repro_torch.core.beam_search import beam_search, descend
from repro_torch.index import flat as tflat
from repro_torch.index import hnsw as thnsw

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

RTOL = ATOL = 1e-5
TOTAL_TOL = 1e-4
EPS = {"l2": -1.0, "cos": 0.95}
STATS = ("expansions", "growths", "search_calls", "div_calls", "certified",
         "exhausted", "K_final")
# (metric, M, ef_construction, seed, rows, permuted insert order)
CASES = {"l2": ("l2", 8, 40, 0, 400, False),
         "ip": ("ip", 8, 40, 0, 400, False),
         "cos": ("cos", 8, 40, 0, 400, False),
         "M4-seed1": ("l2", 4, 40, 1, 400, False),
         "order": ("cos", 8, 40, 0, 300, True)}


def _build(mod, x, metric, M, ef, seed, order, **kw):
    b = mod.HNSWBuilder(x, metric, M, ef, seed, **kw)
    return b, b.build(order=order)


@pytest.fixture(scope="module")
def builds(clustered_data):
    """Each case built once by both packages: ``{case: (ref_builder,
    ref_graph, port_builder, port_graph)}``."""
    out = {}
    for case, (metric, M, ef, seed, rows, permuted) in CASES.items():
        x = clustered_data[:rows]
        order = (np.random.default_rng(5).permutation(rows) if permuted
                 else None)
        jb, jg = _build(jhnsw, x, metric, M, ef, seed, order)
        tb, tg = _build(thnsw, x, metric, M, ef, seed, order, device="cpu")
        out[case] = (jb, jg, tb, tg)
    return out


def _queries(x, num, seed):
    rng = np.random.default_rng(seed)
    return (x[rng.integers(0, x.shape[0], num)]
            + rng.normal(size=(num, x.shape[1])).astype(np.float32) * 0.05
            ).astype(np.float32)


def _assert_same(got, ref, what=""):
    np.testing.assert_array_equal(got.ids, np.asarray(ref.ids), err_msg=what)
    np.testing.assert_allclose(got.scores, np.asarray(ref.scores), rtol=RTOL,
                               atol=ATOL, err_msg=what)
    for f in STATS:
        np.testing.assert_array_equal(getattr(got.stats, f),
                                      getattr(ref.stats, f), err_msg=(what, f))


@pytest.mark.parametrize("case", list(CASES))
def test_build_hnsw_matches_reference_bit_for_bit(builds, case):
    jb, jg, tb, tg = builds[case]
    np.testing.assert_array_equal(tb.levels, jb.levels)
    assert tb.adj == jb.adj
    assert tg.entry == int(jg.entry) == jb.entry
    assert tg.metric == jg.metric and tg.device.type == "cpu"
    np.testing.assert_array_equal(tg.neighbors.numpy(),
                                  np.asarray(jg.neighbors))
    np.testing.assert_array_equal(tg.upper.numpy(), np.asarray(jg.upper))
    np.testing.assert_array_equal(tg.vectors.numpy(), np.asarray(jg.vectors))
    assert tg.neighbors.dtype == tg.upper.dtype == torch.int32
    # the entry is a node of the top level
    assert int(tb.levels[tg.entry]) == tb.max_level == tg.num_upper_levels


def test_build_hnsw_entry_point_matches_reference(clustered_data):
    """``build_hnsw``'s defaults (M = 16, ef_construction = 200, seed 0)
    give the reference's graph."""
    x = clustered_data[:150]
    jg = jhnsw.build_hnsw(x, "ip")
    tg = thnsw.build_hnsw(x, "ip", device="cpu")
    np.testing.assert_array_equal(tg.neighbors.numpy(),
                                  np.asarray(jg.neighbors))
    np.testing.assert_array_equal(tg.upper.numpy(), np.asarray(jg.upper))
    assert tg.entry == int(jg.entry)


def test_select_neighbors_nan_and_short_lists():
    """The packed-bit selection decides as the reference's loop: a NaN
    similarity fails its test, m caps the kept set, and the backfill keeps
    candidate order."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(12, 6)).astype(np.float32)
    x[3] = np.nan
    jb = jhnsw.HNSWBuilder(x, "ip", 4, 10, 0)
    tb = thnsw.HNSWBuilder(x, "ip", 4, 10, 0, device="cpu")
    for m in (0, 1, 3, 8, 12):
        for seed in range(6):
            r = np.random.default_rng(seed)
            ids = r.permutation(12)[: r.integers(1, 13)]
            sims = np.sort(r.normal(size=ids.size))[::-1].astype(np.float32)
            if seed % 2:
                sims = sims.astype(np.float64)
            assert tb._select_neighbors(ids, sims, m) == \
                jb._select_neighbors(ids, sims, m), (m, seed)


def test_hnsw_recall_through_port_beam_search(clustered_data):
    """The port's counterpart of tests/test_index.py's recall test."""
    x = clustered_data[:400]
    g = thnsw.build_hnsw(x, metric="l2", M=8, ef_construction=60,
                         device="cpu")
    rng = np.random.default_rng(0)
    recs = []
    for _ in range(8):
        q = x[rng.integers(len(x))] + \
            rng.normal(size=x.shape[1]).astype(np.float32) * 0.05
        ids, _ = beam_search(g, torch.from_numpy(q), k=5, L=60)
        gt, _ = tflat.exact_topk(q[None], x, 5, "l2", device="cpu")
        recs.append(len(set(np.asarray(ids).tolist())
                        & set(gt[0].tolist())) / 5)
    assert np.mean(recs) >= 0.95


def test_hnsw_has_upper_levels(clustered_data):
    g = thnsw.build_hnsw(clustered_data[:500], metric="l2", M=8,
                         ef_construction=40, device="cpu")
    assert g.num_upper_levels >= 1
    assert g.upper.shape == (g.num_upper_levels, 500, 8)


@pytest.mark.parametrize("case", ["l2", "cos"])
def test_descend_on_hnsw_graph_matches_reference(builds, clustered_data,
                                                 case):
    _, jg, _, tg = builds[case]
    qs = _queries(clustered_data, 16, seed=11)
    got = [descend(tg, torch.from_numpy(q)) for q in qs]
    ref_descend = jax.jit(lambda q: jgraph.descend(jg, q))
    want = [int(ref_descend(jnp.asarray(q))) for q in qs]
    assert got == want
    assert len(set(got)) > 1     # the walks do move off the entry


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_batch_pss_on_hnsw_graph_matches_reference(builds, clustered_data,
                                                   metric):
    _, jg, _, tg = builds[metric]
    qs = _queries(clustered_data, 4, seed=3)
    ref = jbp.batch_pss(jg, qs, 5, EPS[metric], ef=10, kernel_impl="ref")
    got = tbp.batch_pss(tg, qs, 5, EPS[metric], ef=10, kernel_impl="ref")
    _assert_same(got, ref, metric)


@pytest.mark.parametrize("method", ["pss", "pgs"])
@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_diverse_search_on_hnsw_graph_matches_reference(
        builds, clustered_data, metric, method):
    _, jg, _, tg = builds[metric]
    for i, q in enumerate(_queries(clustered_data, 2, seed=7)):
        ref = japi.diverse_search(jg, q, k=5, eps=EPS[metric], method=method,
                                  ef=10)
        got = tapi.diverse_search(tg, q, k=5, eps=EPS[metric], method=method,
                                  ef=10)
        _assert_same(got, ref, f"{method} {metric} query {i}")
        assert abs(got.total - ref.total) <= TOTAL_TOL


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_per_query_pss_equals_batch_pss_on_hnsw_graph(builds, clustered_data,
                                                      metric):
    _, _, _, tg = builds[metric]
    qs = _queries(clustered_data, 4, seed=23)
    batch = tbp.batch_pss(tg, qs, 5, EPS[metric], ef=10)
    for i, q in enumerate(qs):
        got = tapi.diverse_search(tg, q, 5, EPS[metric], "pss", ef=10)
        np.testing.assert_array_equal(got.ids, batch.ids[i])
        np.testing.assert_array_equal(got.scores.view(np.int32),
                                      batch.scores[i].view(np.int32))
        for f in STATS:
            assert getattr(got.stats, f) == getattr(batch.stats, f)[i], (i, f)
