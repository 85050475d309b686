"""The paper's per-query API: repro_torch.core.api.diverse_search (PSS, PDS,
PGS, Alg. 2-4, and the Greedy / IP-greedy baselines), the progressive
driver, progressive beam search and the growth rebuild, against
repro.core on the conftest graphs (shared through to_host -> from_host),
on the CPU with the reference at impl="ref".

Ids, selections, counts and every SearchStats field must be equal; scores
may differ by rtol = atol = 1e-5 and totals by 1e-4 (the two packages
reduce in different orders). Inside the port, the per-query drivers must
equal the batched engine's lanes bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.core import api as japi
from repro.core import beam_search as jbs
from repro.core import pds as jpds
from repro.core import progressive as jprog
from repro.core import pss as jpss
from repro.core.graph import make_flat_graph as jmake
from repro.core.graph import to_host
from repro.core.pgs import pgs as jpgs
from repro.index.flat import build_knn_graph
from repro_torch import quant as tq
from repro_torch.core import api as tapi
from repro_torch.core import batch_progressive as tbp
from repro_torch.core import beam_search as tbs
from repro_torch.core import graph as tgraph
from repro_torch.core import pds as tpds
from repro_torch.core import progressive as tprog
from repro_torch.core import pss as tpss
from repro_torch.core.pgs import pgs as tpgs

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

RTOL = ATOL = 1e-5
TOTAL_TOL = 1e-4
EPS = {"l2": 0.0, "cos": 0.98}
STATS = ("expansions", "growths", "search_calls", "div_calls", "certified",
         "exhausted", "K_final")


@pytest.fixture(scope="module")
def graphs(small_graph, small_graph_cos):
    return {"l2": (small_graph, tgraph.from_host(to_host(small_graph),
                                                 device="cpu")),
            "cos": (small_graph_cos,
                    tgraph.from_host(to_host(small_graph_cos), device="cpu"))}


def _queries(x, num=3, seed=3):
    rng = np.random.default_rng(seed)
    return (x[rng.integers(0, x.shape[0], num)]
            + rng.normal(size=(num, x.shape[1])) * 0.05).astype(np.float32)


def _assert_same(got, ref, what=""):
    np.testing.assert_array_equal(got.ids, np.asarray(ref.ids), err_msg=what)
    np.testing.assert_allclose(got.scores, np.asarray(ref.scores), rtol=RTOL,
                               atol=ATOL, err_msg=what)
    assert abs(got.total - ref.total) <= TOTAL_TOL, what
    for f in STATS:
        assert getattr(got.stats, f) == getattr(ref.stats, f), (what, f)


def _assert_state_equal(got: tbs.SearchState, ref, what=""):
    """A one-lane port state against the reference's (queue ids, scores,
    stable flags, visited set, steps)."""
    np.testing.assert_array_equal(got.queue.ids[0].numpy(),
                                  np.asarray(ref.queue.ids), err_msg=what)
    np.testing.assert_allclose(got.queue.scores[0].numpy(),
                               np.asarray(ref.queue.scores), rtol=RTOL,
                               atol=ATOL, err_msg=what)
    np.testing.assert_array_equal(got.queue.stable[0].numpy(),
                                  np.asarray(ref.queue.stable), err_msg=what)
    np.testing.assert_array_equal(got.visited[0].numpy(),
                                  np.asarray(ref.visited), err_msg=what)
    assert int(got.steps[0]) == int(ref.steps), what


@pytest.mark.parametrize("k", [5, 10])
@pytest.mark.parametrize("metric", ["l2", "cos"])
@pytest.mark.parametrize("method", ["pss", "pgs", "pds", "greedy",
                                    "ip_greedy"])
def test_diverse_search_matches_reference(graphs, clustered_data, method,
                                          metric, k):
    jg, tg = graphs[metric]
    kw = dict(L=128) if method in ("greedy", "ip_greedy") else dict(ef=10)
    for i, q in enumerate(_queries(clustered_data)):
        ref = japi.diverse_search(jg, q, k=k, eps=EPS[metric], method=method,
                                  **kw)
        got = tapi.diverse_search(tg, q, k=k, eps=EPS[metric], method=method,
                                  **kw)
        _assert_same(got, ref, f"{method} {metric} k={k} query {i}")


def test_ip_greedy_lam_and_default_beam(graphs, clustered_data):
    """``lam`` goes to IP-greedy through the API; the default beam is the
    paper's L = 400."""
    jg, tg = graphs["cos"]
    q = _queries(clustered_data, num=1, seed=9)[0]
    for lam in (0.3, 0.9):
        _assert_same(tapi.diverse_search(tg, q, 5, 0.0, "ip_greedy", lam=lam),
                     japi.diverse_search(jg, q, 5, 0.0, "ip_greedy", lam=lam),
                     f"lam={lam}")


def test_unknown_method_raises(graphs, clustered_data):
    _, tg = graphs["l2"]
    with pytest.raises(ValueError, match="unknown method"):
        tapi.diverse_search(tg, clustered_data[0], 5, 0.0, method="dpp")


def test_growth_rebuild_matches_reference(graphs, clustered_data):
    """capacity0 = 16 forces rebuild_for_growth: the rebuilt states, the
    growths and PGS's result through that driver equal the reference's."""
    jg, tg = graphs["l2"]
    q = _queries(clustered_data, num=1, seed=21)[0]
    jd = jprog.ProgressiveDriver(jg, q, 10, 5, capacity0=16)
    td = tprog.ProgressiveDriver(tg, q, 10, 5, capacity0=16)
    for target in (12, 40, 130):
        assert td.ensure_stable(target) == jd.ensure_stable(target)
        assert (td.capacity, td.stats.growths) == (jd.capacity,
                                                   jd.stats.growths)
        _assert_state_equal(td.state, jd.state, f"target {target}")
    assert td.stats.growths >= 2
    ref, _, refK = jpgs(jg, q, 5, EPS["l2"], 10,
                        driver=jprog.ProgressiveDriver(jg, q, 10, 5,
                                                       capacity0=16))
    got, drv, gotK = tpgs(tg, q, 5, EPS["l2"], 10,
                          driver=tprog.ProgressiveDriver(tg, q, 10, 5,
                                                         capacity0=16))
    _assert_same(got, ref)
    assert gotK == refK and drv.stats.growths > 0


@pytest.mark.parametrize("scheme", ["float", "int8"])
def test_rebuild_for_growth_matches_reference(small_graph, clustered_data,
                                              scheme):
    host = to_host(small_graph)
    x = clustered_data
    if scheme == "float":
        jv, tv = x, x
    else:
        jv = jq.quantize_corpus(x, "int8", seed=2)
        tv = tq.corpus_from_host(dict(codes=np.asarray(jv.codes),
                                      scales=np.asarray(jv.scales),
                                      scale_rows=jv.scale_rows), device="cpu")
    jg = jmake(jv, host["neighbors"], None, host["entry"], "l2")
    tg = tgraph.make_flat_graph(tv, host["neighbors"], None, host["entry"],
                                "l2", device="cpu")
    q = x[3] + 0.01
    js = jbs.run_search(jg, jnp.asarray(q), jbs.init_state(jg, jnp.asarray(q),
                                                           64), 48)
    qs = torch.from_numpy(q[None])
    ts = tbs.run_search(tg, qs, tbs.init_state(tg, qs, 64), 48)
    _assert_state_equal(ts, js, "before")
    _assert_state_equal(tbs.rebuild_for_growth(tg, qs, ts, 256),
                        jbs.rebuild_for_growth(jg, jnp.asarray(q), js, 256),
                        "rebuilt")


def test_progressive_resume_matches_oneshot(graphs, clustered_data):
    """progressive_beam_search resumed (queue reuse) equals one shot, and
    each equals the reference's."""
    jg, tg = graphs["l2"]
    q = clustered_data[7] + 0.02
    qs = torch.from_numpy(q[None])
    one = tbs.progressive_beam_search(tg, qs, tbs.init_state(tg, qs, 256),
                                      12, 10)
    two = tbs.progressive_beam_search(tg, qs, tbs.init_state(tg, qs, 256),
                                      4, 10)
    two = tbs.progressive_beam_search(tg, qs, two, 12, 10)
    assert torch.equal(one.queue.ids[0, :120], two.queue.ids[0, :120])
    jq_ = jnp.asarray(q)
    ref = jbs.progressive_beam_search(jg, jq_, jbs.init_state(jg, jq_, 256),
                                      12, 10)
    _assert_state_equal(one, ref)


def test_pds_na_exit(graphs, clustered_data):
    """A max_K below Theorem 1's estimate flags the query N/A (exhausted,
    not certified), as the reference does."""
    jg, tg = graphs["l2"]
    for i, q in enumerate(_queries(clustered_data, num=2, seed=13)):
        ref = jpds.pds(jg, q, 5, -1.0, ef=10, max_K=8)
        got = tpds.pds(tg, q, 5, -1.0, ef=10, max_K=8)
        _assert_same(got, ref, f"query {i}")
        assert got.stats.exhausted and not got.stats.certified


def test_pss_exhausted_on_a_small_graph(clustered_data):
    """n = 64 < K*ef: the whole graph is explored and PSS stops exhausted."""
    x = clustered_data[:64]
    jg = build_knn_graph(x, metric="l2", M=8)
    tg = tgraph.from_host(to_host(jg), device="cpu")
    for i, q in enumerate(_queries(x, num=2, seed=17)):
        ref = jpss.pss(jg, q, 5, 0.5, ef=20)
        got = tpss.pss(tg, q, 5, 0.5, ef=20)
        _assert_same(got, ref, f"query {i}")
        assert got.stats.exhausted


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_per_query_equals_batched_lanes(graphs, clustered_data, metric):
    """Inside the port: per-query pss / pgs / pds equal batch_pss /
    batch_pgs / batch_pds lane for lane, bit for bit."""
    _, tg = graphs[metric]
    qs = _queries(clustered_data, num=4, seed=23)
    eps = EPS[metric]
    lanes = {"pss": tbp.batch_pss(tg, qs, 5, eps, ef=10),
             "pgs": tbp.batch_pgs(tg, qs, 5, eps, ef=10)[0],
             "pds": tbp.batch_pds(tg, qs, 5, eps, ef=10, max_K=64)}
    for method, batch in lanes.items():
        kw = dict(max_K=64) if method == "pds" else {}
        for i, q in enumerate(qs):
            got = tapi.diverse_search(tg, q, 5, eps, method, ef=10, **kw)
            np.testing.assert_array_equal(got.ids, batch.ids[i])
            np.testing.assert_array_equal(got.scores.view(np.int32),
                                          batch.scores[i].view(np.int32))
            for f in STATS:
                assert getattr(got.stats, f) == getattr(batch.stats, f)[i], (
                    method, i, f)
