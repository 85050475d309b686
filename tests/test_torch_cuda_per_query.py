"""The paper's per-query API on the card: every ``diverse_search`` method,
the div-A* oracle and the batch baselines on the kernel rung against the
same calls on the plain versions (``ops.set_default_impl("ref")``) on the
card, with no JAX needed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_per_query.py -q

Without a card every test here skips. The graph (3 000 rows) is built on
the card. The similarity kernels equal their plain versions bit for bit
(tests/test_torch_cuda_kernels.py), and at these eps no candidate pair sits
within a rounding of eps, so ids, score bits and every statistic must be
equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import api, baselines, batch
from repro_torch.core import batch_progressive as tbp
from repro_torch.core import diversity_graph as tdg
from repro_torch.index.flat import build_knn_graph
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
    return build_knn_graph(x, "l2", M=8, device=cuda_device), qs


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


@pytest.mark.parametrize("method", ["pss", "pgs", "pds", "greedy",
                                    "ip_greedy"])
def test_cuda_diverse_search_equals_plain(world, method):
    graph, qs = world
    kw = (dict(L=128) if method in ("greedy", "ip_greedy")
          else dict(ef=10, max_K=256) if method == "pds" else dict(ef=10))
    for i, q in enumerate(qs):
        eps = EPSS[i % 2]
        got, want, launches = _on_both(lambda: api.diverse_search(
            graph, q, K, eps, method=method, **kw))
        _assert_same(got, want, f"{method} query {i}")
        assert launches["batch_similarity_gather"] > 0
        if method != "ip_greedy":
            assert launches["pairwise_adjacency"] > 0


def test_cuda_oracle_and_batch_baselines_equal_plain(world):
    graph, qs = world
    for i, q in enumerate(qs[:3]):
        got, want, launches = _on_both(lambda: baselines.div_astar_oracle(
            graph.vectors, "l2", q, K, EPSS[1], X=64))
        _assert_same(got, want, f"oracle query {i}")
        assert launches["pairwise_adjacency"] >= 1
    got, want, launches = _on_both(lambda: [t.cpu() for t in (
        *batch.batch_greedy_diverse(graph, qs, K, EPSS[0], L=64),
        *batch.batch_optimal_diverse(graph, qs, K, EPSS[0], K=32))])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert launches["greedy_diversify"] == 1
    assert launches["pairwise_adjacency"] == 2


@pytest.mark.parametrize("W", [1, 64, 1024, 2048])
def test_cuda_single_lane_greedy_equals_plain(cuda_device, W):
    g = torch.Generator(device=cuda_device).manual_seed(W)
    scores = torch.round(torch.randn(W, generator=g, device=cuda_device),
                         decimals=1)
    valid = torch.rand(W, generator=g, device=cuda_device) > 0.1
    adj = torch.rand((W, W), generator=g, device=cuda_device) < 0.02
    adj = (adj | adj.T) & ~torch.eye(W, dtype=torch.bool, device=cuda_device)
    for k in (1, 10, 16):
        got = tops.greedy_diversify(scores, adj, k, valid, impl="cuda")
        want = tops.greedy_diversify(scores, adj, k, valid, impl="ref")
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


def test_cuda_per_query_pss_equals_batch_pss(world):
    graph, qs = world
    for eps in EPSS:
        lanes = tbp.batch_pss(graph, qs, K, eps, ef=10)
        for i, q in enumerate(qs):
            one = api.diverse_search(graph, q, K, eps, "pss", ef=10)
            np.testing.assert_array_equal(one.ids, lanes.ids[i])
            np.testing.assert_array_equal(one.scores.view(np.int32),
                                          lanes.scores[i].view(np.int32))
            for f in ("certified", "exhausted", "K_final", "growths"):
                assert getattr(one.stats, f) == getattr(lanes.stats, f)[i]


def test_cuda_pds_extend_adjacency_equals_plain(world, monkeypatch):
    """At k = 16, eps = -0.5 and ef = 1 PDS's prefix grows from a full
    64-wide bucket to 128 (on the CPU, query 4), so ``prefix_adjacency``
    extends G^eps with ``extend_adjacency``, which scores the fresh rows
    with ``sim_many``. Every call is counted; the extension must run, with
    fresh rows, on the kernel rung, and the results equal the plain
    versions' bit for bit."""
    graph, qs = world
    fresh = []
    extend = tdg.extend_adjacency

    def counted(g, old_adj, old_ids, new_ids, eps, impl=None):
        fresh.append(new_ids.shape[0] - old_ids.shape[0])
        return extend(g, old_adj, old_ids, new_ids, eps, impl)

    monkeypatch.setattr(tdg, "extend_adjacency", counted)
    kernel_fresh = 0
    for i, q in enumerate(qs):
        fresh.clear()
        got, want, launches = _on_both(lambda: api.diverse_search(
            graph, q, 16, -0.5, method="pds", ef=1, max_K=256))
        _assert_same(got, want, f"pds query {i}")
        # the two rungs extend at the same widths: _on_both runs the
        # kernel rung first, then the plain one
        half = len(fresh) // 2
        assert fresh[:half] == fresh[half:], fresh
        kernel_fresh += sum(f > 0 for f in fresh[:half])
        if any(f > 0 for f in fresh[:half]):
            assert launches["batch_similarity_many"] > 0
    assert kernel_fresh >= 1
