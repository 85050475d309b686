"""Elastic rescaling on the card, with no JAX needed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_elastic.py -q

Without a card every test here skips. ``migrate_sharded_state`` runs on the
card's tensors and must equal, bit for bit, the reference's numpy algorithm
(``_migrate_numpy``, a copy of ``repro.sharded_search.migrate_sharded_state``
without its JAX wrapping). An int8 reshard on the card re-blocks codes and
scales exactly. A served engine moved 2 -> 4 -> 2 shards, idle and with
lanes in flight, gives the results the same engine gives on the CPU (its
kernels equal the plain versions bit for bit, tests/test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.compat import make_mesh
from repro_torch.core.backend import LaneRequest
from repro_torch.sharded_search import (ShardedEngine, ShardedSearchState,
                                        build_sharded_index, index_from_host,
                                        index_to_host, state_from_host)
from repro_torch.sharded_search.engine import LANE_RUN
from repro_torch.sharded_search.search import (migrate_sharded_state,
                                               reshard_index)

N, D, K, EPS = 4096, 16, 5, 4.0

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _migrate_numpy(state: dict, num_shards: int, capacity=None,
                   num_lanes=None) -> dict:
    """The reference's host migration on numpy leaves."""
    ids, scores, stable = state["ids"], state["scores"], state["stable"]
    visited, steps = state["visited"], state["steps"]
    p_old, B, C_old = ids.shape
    ns_old = visited.shape[-1]
    n = p_old * ns_old
    ns_new = n // num_shards
    C_new = int(capacity or C_old)
    bases_old = (np.arange(p_old, dtype=np.int64) * ns_old)[:, None, None]
    gids = np.where(ids >= 0, ids.astype(np.int64) + bases_old, -1)
    gids = gids.transpose(1, 0, 2).reshape(B, -1)
    sc = scores.transpose(1, 0, 2).reshape(B, -1)
    st = stable.transpose(1, 0, 2).reshape(B, -1)
    new_ids = np.full((num_shards, B, C_new), -1, np.int32)
    new_sc = np.full((num_shards, B, C_new), -np.inf, np.float32)
    new_st = np.ones((num_shards, B, C_new), np.bool_)
    for s in range(num_shards):
        lo, hi = s * ns_new, (s + 1) * ns_new
        for b in range(B):
            sel = (gids[b] >= lo) & (gids[b] < hi)
            g, s_b, t_b = gids[b][sel], sc[b][sel], st[b][sel]
            assert len(g) <= C_new
            order = np.lexsort((g, -s_b))
            m = len(order)
            new_ids[s, b, :m] = (g[order] - lo).astype(np.int32)
            new_sc[s, b, :m] = s_b[order]
            new_st[s, b, :m] = t_b[order]
    new_vis = (visited.transpose(1, 0, 2).reshape(B, n)
               .reshape(B, num_shards, ns_new).transpose(1, 0, 2))
    if num_shards >= p_old:
        new_steps = np.zeros((num_shards, B), np.int32)
        new_steps[::num_shards // p_old] = steps
    else:
        new_steps = steps.reshape(num_shards, p_old // num_shards, B).sum(
            axis=1, dtype=np.int32)
    out = dict(ids=new_ids, scores=new_sc, stable=new_st, visited=new_vis,
               steps=new_steps)
    B_new = int(num_lanes or B)
    if B_new != B:
        fills = dict(ids=-1, scores=-np.inf, stable=True, visited=False,
                     steps=0)
        for f, a in out.items():
            o = np.full(a.shape[:1] + (B_new,) + a.shape[2:], fills[f],
                        a.dtype)
            o[:, :min(B, B_new)] = a[:, :min(B, B_new)]
            out[f] = o
    return out


def _rand_state(rng, p, B, C, ns, ties=False) -> dict:
    ids = np.full((p, B, C), -1, np.int32)
    scores = np.full((p, B, C), -np.inf, np.float32)
    stable = np.ones((p, B, C), bool)
    for s in range(p):
        for b in range(B):
            m = int(rng.integers(0, min(C, ns) + 1))
            loc = rng.choice(ns, size=m, replace=False)
            sc = (rng.choice(np.array([1.5, 0.0, -0.0, -2.0], np.float32),
                             size=m) if ties
                  else rng.normal(size=m).astype(np.float32))
            order = np.lexsort((loc + s * ns, -sc))
            ids[s, b, :m] = loc[order]
            scores[s, b, :m] = sc[order]
            stable[s, b, :m] = rng.random(m) < 0.5
    return dict(ids=ids, scores=scores, stable=stable,
                visited=rng.random((p, B, ns)) < 0.3,
                steps=rng.integers(0, 50, size=(p, B)).astype(np.int32))


def _bits_equal(got: ShardedSearchState, want: dict):
    for f in ShardedSearchState._fields:
        g = getattr(got, f).cpu().numpy()
        assert g.dtype == want[f].dtype and g.shape == want[f].shape, f
        np.testing.assert_array_equal(g.view(np.uint8),
                                      want[f].view(np.uint8), err_msg=f)


@pytest.mark.parametrize("p,B,C,ns,p_new,cap,lanes,ties", [
    (4, 3, 8, 32, 8, None, None, False),
    (4, 3, 8, 32, 2, 16, None, True),
    (4, 2, 8, 16, 1, 32, 4, True),
    (2, 16, 1024, 8192, 4, 1024, 32, False),    # the engine's wide queues
    (4, 16, 2048, 4096, 2, 4096, 8, False),
])
def test_cuda_migration_equals_numpy(cuda_device, p, B, C, ns, p_new, cap,
                                     lanes, ties):
    rng = np.random.default_rng(p * 1000 + C)
    host = _rand_state(rng, p, B, C, ns, ties)
    got = migrate_sharded_state(state_from_host(host, device=cuda_device),
                                p_new, capacity=cap, num_lanes=lanes)
    assert got.ids.device.type == "cuda"
    _bits_equal(got, _migrate_numpy(host, p_new, cap, lanes))


def test_cuda_migration_overflow_raises(cuda_device):
    host = _rand_state(np.random.default_rng(5), 4, 2, 8, 8)
    host["ids"][:] = np.arange(8, dtype=np.int32)
    host["scores"][:] = np.linspace(1, 0, 8, dtype=np.float32)
    with pytest.raises(ValueError, match="capacity"):
        migrate_sharded_state(state_from_host(host, device=cuda_device), 2)


def test_cuda_int8_reshard_reblocks_exactly(cuda_device):
    x = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)
    i8 = build_sharded_index(x, 4, "l2", M=8, quantized="int8",
                             device=cuda_device)
    for p_new in (8, 2):
        r = reshard_index(i8, p_new, x)
        assert r.codes.device.type == "cuda"
        assert torch.equal(r.codes.reshape(N, -1), i8.codes.reshape(N, -1))
        assert torch.equal(r.scales.reshape(-1), i8.scales.reshape(-1))
        assert r.num_shards == p_new and r.shard_size == N // p_new
        assert torch.equal(reshard_index(r, 4, x).codes, i8.codes)


def _serve_straddling(index2, index4, x, qs, device):
    """Four lanes admitted on 2 shards step once, move to 4 shards, step,
    move back to 2 and finish; then the same queries served again on the
    idle engine after a second round trip."""
    mesh2 = make_mesh((2,), ("data",), device=device)
    eng = ShardedEngine(index2, x, mesh2, num_lanes=4, K0=16, max_k=8,
                        record_candidates=True)
    eng.prepare_rescale(4, make_mesh((4,), ("data",), device=device),
                        index=index4, prewarm=False)

    def admit_all():
        for lane in range(4):
            eng.admit(lane, LaneRequest(q=qs[lane], k=K, eps=EPS,
                                        method="sharded"))

    out = {}
    admit_all()
    eng.step()
    straddled = int((eng.status == LANE_RUN).sum())
    assert eng.rescale(4)
    eng.step()
    assert eng.rescale(2)
    while eng.active_count():
        eng.step()
    for lane, r in eng.harvest():
        out[("straddle", lane)] = r
        eng.recycle(lane)
    assert eng.rescale(4) and eng.rescale(2)
    admit_all()
    while eng.active_count():
        eng.step()
    for lane, r in eng.harvest():
        out[("again", lane)] = r
        eng.recycle(lane)
    return out, straddled


def test_cuda_engine_round_trip_2_4_2(cuda_device):
    """The same straddling run on the card and on the CPU, over the same
    shard graphs: every result equal, score bits included."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(N, D)).astype(np.float32)
    qs = rng.normal(size=(4, D)).astype(np.float32)
    host2 = index_to_host(build_sharded_index(x, 2, "ip", M=8, device="cpu"))
    host4 = index_to_host(reshard_index(index_from_host(host2, "cpu"), 4))
    runs = {}
    for dev in ("cpu", cuda_device):
        runs[str(dev)] = _serve_straddling(index_from_host(host2, dev),
                                           index_from_host(host4, dev), x,
                                           qs, dev)
    (got, straddled), (want, _) = runs["cuda"], runs["cpu"]
    assert straddled >= 1 and sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert np.array_equal(g.ids, w.ids), key
        assert np.array_equal(g.scores.view(np.int32),
                              w.scores.view(np.int32)), key
        assert vars(g.stats) == vars(w.stats), key
    for lane in range(4):   # served again after the round trip: unchanged
        assert np.array_equal(got[("again", lane)].ids,
                              got[("straddle", lane)].ids), lane


def test_cuda_swap_index_refuses_occupied_lanes(cuda_device):
    x = np.random.default_rng(3).normal(size=(1024, D)).astype(np.float32)
    idx = build_sharded_index(x, 2, "l2", M=8, device=cuda_device)
    eng = ShardedEngine(idx, x, make_mesh((2,), ("data",), device=cuda_device),
                        num_lanes=2, K0=16, max_k=8)
    eng.admit(0, LaneRequest(q=x[0], k=K, eps=1.0, method="sharded"))
    with pytest.raises(RuntimeError, match="occupied"):
        eng.swap_index(idx, x)
    while eng.active_count():
        eng.step()
    eng.swap_index(idx, x)
    assert eng.beam_state.ids.device.type == "cuda"
