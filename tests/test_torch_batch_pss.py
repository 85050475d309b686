"""The slice as a whole: repro_torch's batched engine against
repro.core.batch_progressive on the conftest graph (shared through
to_host -> from_host), on the CPU with the reference at impl="ref"."""
import numpy as np
import pytest
import torch

from repro.core import batch_progressive as jbp
from repro.core.graph import to_host
from repro_torch.core import batch_progressive as tbp
from repro_torch.core.backend import LaneRequest
from repro_torch.core.graph import from_host

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

EPS = {"l2": (-1.0, -3.0), "cos": (0.95, 0.98)}


@pytest.fixture(scope="module")
def graphs(small_graph, small_graph_cos):
    return {"l2": (small_graph, from_host(to_host(small_graph), device="cpu")),
            "cos": (small_graph_cos,
                    from_host(to_host(small_graph_cos), device="cpu"))}


def _queries(x, num=4, seed=3):
    rng = np.random.default_rng(seed)
    return (x[rng.integers(0, x.shape[0], num)]
            + rng.normal(size=(num, x.shape[1])).astype(np.float32) * 0.05
            ).astype(np.float32)


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.ids, np.asarray(ref.ids))
    np.testing.assert_allclose(got.scores, np.asarray(ref.scores),
                               rtol=1e-5, atol=1e-5)
    for field in ("certified", "exhausted", "K_final", "expansions",
                  "growths", "search_calls", "div_calls"):
        np.testing.assert_array_equal(getattr(got.stats, field),
                                      getattr(ref.stats, field), err_msg=field)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("k", [5, 10])
@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_batch_pss_matches_reference(graphs, clustered_data, metric, k, level):
    jg, tg = graphs[metric]
    qs = _queries(clustered_data)
    eps = EPS[metric][level]
    ref = jbp.batch_pss(jg, qs, k, eps, ef=10, kernel_impl="ref")
    got = tbp.batch_pss(tg, qs, k, eps, ef=10, kernel_impl="ref")
    _assert_same(got, ref)


def test_batch_pgs_and_pds_match_reference(graphs, clustered_data):
    jg, tg = graphs["l2"]
    qs = _queries(clustered_data, seed=5)
    ref, _, refK = jbp.batch_pgs(jg, qs, 5, -1.0, ef=10)
    got, _, gotK = tbp.batch_pgs(tg, qs, 5, -1.0, ef=10)
    _assert_same(got, ref)
    np.testing.assert_array_equal(gotK, refK)
    _assert_same(tbp.batch_pds(tg, qs, 5, -1.5, ef=10, max_K=200),
                 jbp.batch_pds(jg, qs, 5, -1.5, ef=10, max_K=200))


def test_streams_and_recycled_lanes_match_lockstep(graphs, clustered_data):
    """A recycled lane (continuous batching) serves its new query exactly as
    a fresh lockstep run does, and streaming splits change nothing."""
    _, tg = graphs["l2"]
    qs = _queries(clustered_data, num=5, seed=7)
    lock = tbp.batch_pss(tg, qs, 5, -1.0, ef=10)
    np.testing.assert_array_equal(
        tbp.batch_pss(tg, qs, 5, -1.0, ef=10, streams=2).ids, lock.ids)
    engine = tbp.ProgressiveEngine(tg, num_lanes=2, max_k=5, default_ef=10)
    pending = list(range(len(qs)))
    served = {}
    while pending or engine.active_count():
        for lane in engine.free_lanes():
            if pending and engine.status[lane] != tbp.LANE_DONE:
                i = pending.pop(0)
                engine.admit(int(lane), LaneRequest(qs[i], 5, -1.0, ef=10))
                served[int(lane), len(served)] = i
        engine.step()
        for lane, res in engine.harvest():
            i = [q for (ln, _), q in served.items() if ln == lane][-1]
            np.testing.assert_array_equal(res.ids, lock.ids[i])
            assert res.stats.certified == bool(lock.stats.certified[i])
            engine.recycle(lane)
    assert engine.signature_log.counts


def test_prewarm_runs_every_stage(graphs):
    _, tg = graphs["cos"]
    engine = tbp.ProgressiveEngine(tg, num_lanes=2, max_k=5, default_ef=10,
                                   max_capacity=512)
    warmed = engine.prewarm(ks=(5,), widths=(64,))
    kinds = {w[0] for w in warmed}
    assert {"search", "rebuild", "adjacency", "greedy", "fused_round",
            "div_astar"} <= kinds
    assert engine.active_count() == 0
