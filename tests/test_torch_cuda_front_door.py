"""The serving front door on the card: DiverseVectorDB on ``cuda`` against
the same facade on the CPU (the plain versions), with no JAX needed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_front_door.py -q

Without a card every test here skips. Both facades serve over one graph
(built on the CPU, moved to the card), so the engine runs the same
trajectory on both; the kernels' scores equal the plain versions' bit for
bit (tests/test_torch_cuda_kernels.py), so ids and certificates must be
equal, and scores too.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.graph import to_device
from repro_torch.db import DiverseVectorDB, Query
from repro_torch.index.flat import build_knn_graph
from repro_torch.kernels import ops as tops

N, D, K = 3000, 24, 5
EPSS = (0.0, -0.5)

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
    qs = (x[rng.integers(0, N, 12)]
          + rng.normal(size=(12, D)) * 0.05).astype(np.float32)
    return x, build_knn_graph(x, "l2", M=8, device="cpu"), qs


def _queries(qs):
    return [Query(q, k=K, eps=EPSS[i % 2]) for i, q in enumerate(qs)]


def _db(graph, device, **kw):
    return DiverseVectorDB(index=to_device(graph, device), num_lanes=4,
                           max_k=8, default_ef=20, prewarm=False,
                           device=device, **kw)


def test_cuda_facade_equals_cpu_facade(cuda_device, world):
    _, graph, qs = world
    tops.reset_launch_counts()
    got = _db(graph, cuda_device).search_batch(_queries(qs))
    launches = tops.launch_counts()
    want = _db(graph, "cpu").search_batch(_queries(qs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.scores, w.scores)
        assert g.stats.certified == w.stats.certified
        assert g.stats.K_final == w.stats.K_final
    for name in ("batch_similarity_gather", "pairwise_adjacency",
                 "fused_round"):
        assert launches[name] > 0, name


def test_cuda_duplicate_query_hits(cuda_device, world):
    _, graph, qs = world
    db = _db(graph, cuda_device, cache_size=16)
    cold = db.search_batch(_queries(qs))
    admitted = db.cache.admitted
    assert admitted > 0
    warm = db.search_batch(_queries(qs))
    assert db.stats()["cache_hits"] == admitted
    for a, b in zip(cold, warm):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)


def test_cuda_deleted_ids_are_never_served(cuda_device, world):
    _, graph, qs = world
    db = _db(graph, cuda_device, cache_size=16)
    first = db.search_batch(_queries(qs))
    dead = sorted({int(r.ids[0]) for r in first})
    db.delete(dead)
    fresh = db.upsert(qs[:4] + np.float32(0.01))
    again = db.search_batch(_queries(qs))
    for i, r in enumerate(again):
        assert not set(dead) & set(r.ids.tolist())
        if i < 4:
            assert int(fresh[i]) in r.ids.tolist()


def test_cuda_background_rebuild_swaps_once(cuda_device, world):
    x, graph, qs = world
    db = _db(graph, cuda_device, delta_capacity=64)
    db.upsert(qs[:6] + np.float32(0.01))
    assert db.rebuild(wait=False) is False
    served = db.search_batch(_queries(qs))   # serves while the build runs
    assert all(r is not None for r in served)
    db.index.wait_rebuild()                 # a build that died swaps never
    db.scheduler.drain()
    db.backend.maybe_swap()                 # unless serving installed it
    st = db.stats()
    assert st["epoch_swaps"] == 1 and st["index"]["epoch"] == 1
    assert db.engine.graph.size == N + 6
    assert db.engine.graph.device.type == "cuda"
    r = db.search(Query(qs[0], k=K, eps=0.0))
    assert N in r.ids.tolist()               # the upserted near-duplicate


@pytest.mark.parametrize("W", [1, 33, 64, 200])
def test_cuda_single_lane_adjacency_is_the_batched_lane(cuda_device, W):
    rng = np.random.default_rng(W)
    x = torch.as_tensor(rng.normal(size=(500, D)).astype(np.float32),
                        device=cuda_device)
    ids = torch.as_tensor(rng.choice(500, W, replace=False).astype(np.int32),
                          device=cuda_device)
    ids[W // 2:] = torch.where(torch.arange(W - W // 2, device=cuda_device)
                               % 3 == 0, -1, ids[W // 2:])
    eps = torch.tensor([-4.0], device=cuda_device)
    batched = tops.pairwise_adjacency_batch(x, ids[None], eps, "l2")[0]
    rows = x[ids.clamp(min=0).long()]
    single = tops.pairwise_adjacency(rows, -4.0, "l2", ids >= 0)
    assert torch.equal(single, batched)
    assert not bool(single.diagonal().any())
