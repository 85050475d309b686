"""The paper's index on the card: an HNSW graph placed on the card equals
the one placed on the CPU, and the engine and per-query PSS over it (the
descent through its upper levels at every admission) on the kernel rung
equal the same calls on the plain versions (``ops.set_default_impl("ref")``)
on the card, with no JAX needed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_hnsw.py -q

Without a card every test here skips. The rows (3 000) and eps are
tests/test_torch_cuda_per_query.py's: no candidate pair sits within a
rounding of eps, so ids, score bits and every statistic must be equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import api
from repro_torch.core import batch_progressive as tbp
from repro_torch.core.backend import LaneRequest
from repro_torch.index.hnsw import build_hnsw
from repro_torch.kernels import ops as tops

N, D, K = 3000, 24, 5
EPSS = (0.0, -0.5)
STATS = ("expansions", "growths", "search_calls", "div_calls", "certified",
         "exhausted", "K_final")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def world(cuda_device):
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(24, D)) * 2.0
    x = (centers[rng.integers(0, 24, N)]
         + rng.normal(size=(N, D)) * 0.3).astype(np.float32)
    qs = (x[rng.integers(0, N, 6)]
          + rng.normal(size=(6, D)) * 0.05).astype(np.float32)
    return x, build_hnsw(x, "l2", M=8, ef_construction=40,
                         device=cuda_device), qs


def _on_both(fn):
    """``fn()`` on the kernel rung, then with every op on the plain
    versions; the launches of the kernel run."""
    tops.reset_launch_counts()
    got = fn()
    launches = tops.launch_counts()
    tops.set_default_impl("ref")
    try:
        want = fn()
    finally:
        tops.set_default_impl(None)
    return got, want, launches


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got.ids, want.ids, err_msg=what)
    np.testing.assert_array_equal(got.scores.view(np.int32),
                                  want.scores.view(np.int32), err_msg=what)
    for f in STATS:
        assert getattr(got.stats, f) == getattr(want.stats, f), (what, f)


def test_cuda_build_hnsw_equals_cpu_build(world):
    x, graph, _ = world
    cpu = build_hnsw(x, "l2", M=8, ef_construction=40, device="cpu")
    assert graph.device.type == "cuda" and graph.num_upper_levels >= 1
    for f in ("vectors", "neighbors", "upper"):
        assert torch.equal(getattr(graph, f).cpu(), getattr(cpu, f)), f
    assert graph.entry == cpu.entry


def _serve(graph, qs):
    """Continuous batching of the queries over a 2-lane engine, eps
    alternating; results in query order."""
    engine = tbp.ProgressiveEngine(graph, num_lanes=2, max_k=K,
                                   default_ef=10)
    pending, lane_query, out = list(range(len(qs))), {}, [None] * len(qs)
    while pending or engine.active_count():
        for lane in engine.free_lanes():
            if pending:
                i = pending.pop(0)
                engine.admit(int(lane), LaneRequest(qs[i], K, EPSS[i % 2],
                                                    ef=10))
                lane_query[int(lane)] = i
        engine.step()
        for lane, res in engine.harvest():
            out[lane_query.pop(lane)] = res
            engine.recycle(lane)
    return out


def test_cuda_engine_on_hnsw_equals_plain(world):
    _, graph, qs = world
    got, want, launches = _on_both(lambda: _serve(graph, qs))
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"engine query {i}")
    assert launches["batch_similarity_gather"] > 0
    assert launches["fused_round"] > 0 or launches["pairwise_adjacency"] > 0


def test_cuda_per_query_pss_on_hnsw_equals_plain(world):
    _, graph, qs = world
    for i, q in enumerate(qs):
        got, want, launches = _on_both(lambda: api.diverse_search(
            graph, q, K, EPSS[i % 2], "pss", ef=10))
        _assert_same(got, want, f"pss query {i}")
        assert launches["pairwise_adjacency"] > 0


def test_cuda_per_query_pss_equals_engine_on_hnsw(world):
    """Per-query PSS equals the continuously served lanes and the
    lockstep batch, bit for bit."""
    _, graph, qs = world
    served = _serve(graph, qs)
    for eps in EPSS:
        lanes = tbp.batch_pss(graph, qs, K, eps, ef=10)
        for i, q in enumerate(qs):
            one = api.diverse_search(graph, q, K, eps, "pss", ef=10)
            np.testing.assert_array_equal(one.ids, lanes.ids[i])
            np.testing.assert_array_equal(one.scores.view(np.int32),
                                          lanes.scores[i].view(np.int32))
            for f in ("certified", "exhausted", "K_final", "growths"):
                assert getattr(one.stats, f) == getattr(lanes.stats, f)[i]
            if EPSS[i % 2] == eps:
                _assert_same(one, served[i], f"served query {i}")
