"""repro_torch's ShardedEngine and quantized sharded search against
repro.sharded_search on the CPU, at P = 1.

The world and the comparison rules are ``test_torch_sharded_search.py``'s:
the reference builds each ``ShardedIndex`` and ``index_from_host`` carries
it across; per lane, ids, certificates, K_final, expansions, growths /
rounds and the last candidate frontier must be equal, scores within 1e-5.
The engine serves more queries than it has lanes (continuous admission
between rounds) under both resume modes; the int8 and PQ indexes go
through the exact float rerank of the merged frontier.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sharded_search import EPSS, World, _same, world  # noqa: F401

from repro import sharded_search as J
from repro.core.backend import LaneRequest as JRequest
from repro_torch import sharded_search as T
from repro_torch.core import beam_search as tbs
from repro_torch.core.backend import LaneRequest as TRequest

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def quantized():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 12)).astype(np.float32)
    qs = rng.normal(size=(6, 12)).astype(np.float32)
    return {s: World(x, J.build_sharded_index(x, 1, "ip", M=8, quantized=s),
                     qs) for s in ("int8", "pq")}


def _serve(eng, request_cls, qs, k):
    """Admit waiting queries into free lanes (lane order) between rounds,
    step, harvest and recycle until every query is served."""
    pending, owner, out = list(range(len(qs))), {}, {}
    while pending or eng.active_count():
        for lane in eng.free_lanes():
            if not pending:
                break
            i = pending.pop(0)
            eng.admit(int(lane), request_cls(q=qs[i], k=k,
                                             eps=float(EPSS[i]),
                                             method="sharded"))
            owner[int(lane)] = i
        eng.step()
        for lane, res in eng.harvest():
            out[owner.pop(lane)] = (res, eng.last_candidates[lane])
            eng.recycle(lane)
    return out


def _same_results(got, ref):
    assert sorted(got) == sorted(ref)
    for i in ref:
        (g, gc), (r, rc) = got[i], ref[i]
        _same(g.ids, r.ids, f"query {i} ids")
        _same(g.scores, r.scores, f"query {i} scores")
        assert vars(g.stats) == vars(r.stats), (i, g.stats, r.stats)
        assert (gc is None) == (rc is None), i
        if rc is not None:
            _same(gc[0], rc[0], f"query {i} cand ids")
            _same(gc[1], rc[1], f"query {i} cand scores")


@pytest.mark.parametrize("resume", ["beam", "scratch"])
def test_sharded_engine_p1(world, resume):
    """Four queries through two lanes: continuous admission, per-lane
    budgets, counters and candidate frontiers as the reference's."""
    kw = dict(num_lanes=2, K0=16, max_k=8, resume=resume,
              record_candidates=True)
    jeng = J.ShardedEngine(world.jidx, jnp.asarray(world.x), world.jmesh,
                           **kw)
    teng = T.ShardedEngine(world.tidx, world.x, world.tmesh, **kw)
    assert teng.prewarm() == jeng.prewarm()
    ref = _serve(jeng, JRequest, world.qs[:4], 4)
    got = _serve(teng, TRequest, world.qs[:4], 4)
    _same_results(got, ref)
    assert teng.signatures.counts == jeng.signatures.counts
    assert any(r.stats.search_calls > 1 for r, _ in got.values())


@pytest.mark.parametrize("scheme", ["int8", "pq"])
def test_sharded_quantized_p1(quantized, scheme):
    """A quantized index: compressed beams, the exact float rerank of the
    merged frontier, then diversify; the scratch search, and the engine's
    resumed beams with continuous admission, whose recorded frontiers are
    the reranked ones."""
    w = quantized[scheme]
    assert w.tidx.scheme == scheme
    assert (w.tidx.corpus_bytes_per_vector()
            == w.jidx.corpus_bytes_per_vector())
    ref = J.sharded_diverse_search(w.jidx, w.x, jnp.asarray(w.qs), 4, EPSS,
                                   32, w.jmesh, with_expansions=True)
    got = T.sharded_diverse_search(w.tidx, w.x, w.qs, 4, EPSS, 32, w.tmesh,
                                   with_expansions=True)
    for g, r, what in zip(got, ref, ("ids", "scores", "certified",
                                     "expansions")):
        _same(g, r, what)
    kw = dict(num_lanes=2, K0=16, max_k=8, record_candidates=True)
    _same_results(
        _serve(T.ShardedEngine(w.tidx, w.x, w.tmesh, **kw), TRequest, w.qs, 4),
        _serve(J.ShardedEngine(w.jidx, w.x, w.jmesh, **kw), JRequest, w.qs, 4))


def test_occupied_prefix_equals_whole_queue(world, monkeypatch):
    """The beam loop works on each queue's occupied prefix; forced to the
    whole resumable queue (256 slots here), the engine serves the same
    ids, score bits, counters and candidate frontiers."""
    kw = dict(num_lanes=2, K0=16, max_k=8, record_candidates=True)

    def serve():
        return _serve(T.ShardedEngine(world.tidx, world.x, world.tmesh, **kw),
                      TRequest, world.qs, 4)

    prefix = serve()
    monkeypatch.setattr(tbs, "_occupied_width", lambda n, capacity: capacity)
    whole = serve()
    assert sorted(prefix) == sorted(whole) == list(range(len(world.qs)))
    for i in prefix:
        (p, pc), (w, wc) = prefix[i], whole[i]
        np.testing.assert_array_equal(p.ids, w.ids)
        np.testing.assert_array_equal(p.scores.view(np.int32),
                                      w.scores.view(np.int32))
        assert vars(p.stats) == vars(w.stats), i
        np.testing.assert_array_equal(pc[0], wc[0])
        np.testing.assert_array_equal(pc[1], wc[1])
