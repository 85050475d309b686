"""The semantic result cache and the Theorem-2 audit: repro_torch.serve.cache
and repro_torch.core.theorems against repro.serve.cache / repro.core.theorems,
on the CPU with the reference at its default rung ("ref" off a TPU).

Tolerances: hit counts, admissions, served ids and certificates equal to
the reference's; a hit's ids and scores equal its first serving bit for
bit; the audit's ids and certificate equal, its min_value and s_K equal
(both sides sum div-A*'s totals in float32 in the same order).
"""
import numpy as np
import pytest
import torch

from repro.core import theorems as jth
from repro.core.graph import to_host
from repro.serve.scheduler import LaneScheduler as JScheduler
from repro_torch.core import theorems as tth
from repro_torch.core.graph import from_host
from repro_torch.core.pgs import DiverseResult
from repro_torch.core.progressive import SearchStats
from repro_torch.core.similarity import query_sim
from repro_torch.serve.cache import SemanticResultCache
from repro_torch.serve.scheduler import LaneScheduler

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

MIX_KS = [5, 3, 5, 3, 5, 3, 5, 3, 5, 3]
MIX_EPS = [0.0, -0.5, 0.0, -0.5, 0.0, -0.5, 0.0, -0.5, 0.0, -0.5]


@pytest.fixture(scope="module")
def world(small_graph, clustered_data):
    rng = np.random.default_rng(0)
    qs = (clustered_data[rng.integers(0, clustered_data.shape[0], 10)]
          + rng.normal(size=(10, clustered_data.shape[1])) * 0.05
          ).astype(np.float32)
    return small_graph, from_host(to_host(small_graph), device="cpu"), qs


def _sched(graph, **kw):
    return LaneScheduler(graph, num_lanes=4, max_k=16, prewarm=False,
                         device="cpu", **kw)


def _recheck(graph, entry, q):
    """Independent recheck of a cached entry's frontier against ``q``:
    the plain similarity (not the cache's kernel path) + the audit."""
    valid = entry.cand_ids >= 0
    vecs = graph.vectors[torch.as_tensor(np.maximum(entry.cand_ids, 0))]
    sc = query_sim(torch.as_tensor(q), vecs, graph.metric).numpy()
    sc = np.where(valid, sc, -np.inf).astype(np.float32)
    order = np.argsort(-sc, kind="stable")
    return tth.theorem2_recheck(graph.vectors.numpy(), graph.metric,
                                entry.cand_ids[order], sc[order], entry.eps,
                                entry.k, device="cpu")


# ------------------------------------------------- scheduler integration ----

def test_exact_duplicate_hits_bit_equal_and_match_reference(world):
    """A repeated trace is served from the cache (no lane), bit-equal to the
    cold pass, with the reference's admissions and hits."""
    jg, tg, qs = world
    sched = _sched(tg, cache_size=32)
    cold = sched.run(qs, MIX_KS, MIX_EPS)
    admitted = sched.cache.admitted
    assert admitted > 0 and sched.total_cache_hits == 0
    warm = sched.run(qs, MIX_KS, MIX_EPS)
    assert sched.total_cache_hits == admitted
    hits = [r for r in sched.completed if r.cache_hit]
    assert len(hits) == admitted
    for r in hits:
        assert r.t_admit == r.t_done and r.lane is None
        assert r.result.stats.certified
    for a, b in zip(cold, warm):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
    st = sched.latency_stats()
    assert st["cache_hit_rate"] == pytest.approx(admitted / 20)
    assert st["cache"]["revalidation_failures"] == 0
    ref = JScheduler(jg, num_lanes=4, max_k=16, prewarm=False, cache_size=32)
    ref_cold = ref.run(qs, MIX_KS, MIX_EPS)
    ref_warm = ref.run(qs, MIX_KS, MIX_EPS)
    assert ref.cache.admitted == admitted
    assert ref.total_cache_hits == sched.total_cache_hits
    for a, b in zip(cold + warm, ref_cold + ref_warm):
        np.testing.assert_array_equal(a.ids, np.asarray(b.ids))
        assert a.stats.certified == b.stats.certified


def test_zero_duplicate_parity_cache_invisible(world):
    """On a trace with no duplicates the cache is invisible: zero hits and
    the uncached scheduler's results, bit for bit."""
    _, tg, qs = world
    ra = _sched(tg).run(qs, MIX_KS, MIX_EPS)
    cached = _sched(tg, cache_size=32)
    rb = cached.run(qs, MIX_KS, MIX_EPS)
    assert cached.total_cache_hits == 0
    for a, b in zip(ra, rb):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.stats.certified == b.stats.certified


def test_near_hits_recheck_and_match_reference(world):
    """Replayed with small perturbations (near-hits, not exact duplicates):
    the port hits exactly where the reference does, and every hit passes
    an independent recheck against its own query."""
    jg, tg, qs = world
    jitter = (np.random.default_rng(5).normal(size=qs.shape) * 1e-3
              ).astype(np.float32)
    sched = _sched(tg, cache_size=32)
    ref = JScheduler(jg, num_lanes=4, max_k=16, prewarm=False, cache_size=32)
    for s in (sched, ref):
        s.run(qs, MIX_KS, MIX_EPS)
    got = sched.run(qs + jitter, MIX_KS, MIX_EPS)
    want = ref.run(qs + jitter, MIX_KS, MIX_EPS)
    hits = [r for r in sched.completed if r.cache_hit]
    assert hits, "the trace must produce at least one near-hit"
    assert [r.rid for r in hits] == [r.rid for r in ref.completed
                                     if r.cache_hit]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ids, np.asarray(b.ids))
    for r in hits:
        cert, sel = _recheck(tg, r.cache_entry, r.q)
        assert cert
        np.testing.assert_array_equal(sel, r.result.ids)


def test_near_hit_threshold_boundary(world):
    """A probe within the slack-derived drift threshold hits (and still
    revalidates); one beyond it misses without attempting revalidation."""
    _, tg, qs = world
    rng = np.random.default_rng(11)
    sched = _sched(tg, cache_size=8)
    sched.run(qs[:1], 5, 0.0)
    cache = sched.cache
    entry = next(iter(cache._entries.values()))
    assert 0.0 < entry.threshold < np.inf

    def probe_at(dist):
        delta = rng.normal(size=qs.shape[1])
        delta = (delta / np.linalg.norm(delta) * dist).astype(np.float32)
        return cache.lookup(entry.q + delta, entry.k, entry.eps,
                            entry.method)

    inside = probe_at(entry.threshold * 0.5)
    assert inside is not None and inside[1] is entry
    fails_before = cache.revalidation_failures
    assert probe_at(entry.threshold * 1.5) is None
    assert cache.revalidation_failures == fails_before


def test_host_and_tensor_corpora_revalidate_alike(world):
    """The same entries over a host corpus and over the graph's tensor give
    the same hits and results."""
    _, tg, qs = world
    out = []
    for vectors in (tg.vectors, tg.vectors.numpy()):
        cache = SemanticResultCache(vectors, "l2", 32, device="cpu")
        sched = _sched(tg, cache=cache)
        sched.run(qs, MIX_KS, MIX_EPS)
        warm = sched.run(qs, MIX_KS, MIX_EPS)
        out.append((sched.total_cache_hits,
                    [(r.ids.tolist(), r.scores.tolist()) for r in warm]))
    assert out[0] == out[1] and out[0][0] > 0


# ------------------------------------------------------------ the audit ----

def _frontier(x, q, K, pad, metric):
    sc = query_sim(torch.as_tensor(q), torch.as_tensor(x), metric).numpy()
    ids = np.lexsort((np.arange(len(sc)), -sc))[:K].astype(np.int32)
    s = sc[ids].astype(np.float32)
    if pad:
        ids = np.concatenate([ids, np.full(pad, -1, np.int32)])
        s = np.concatenate([s, np.full(pad, -np.inf, np.float32)])
    return ids, s


@pytest.mark.parametrize("metric,eps", [("l2", 0.0), ("l2", -0.5),
                                        ("cos", 0.95)])
@pytest.mark.parametrize("k,K,pad", [(1, 8, 0), (3, 16, 0), (5, 32, 0),
                                     (5, 24, 8), (8, 64, 0)])
def test_theorem2_audit_matches_reference(clustered_data, metric, eps, k, K,
                                          pad):
    """Same frontier in, the reference's certificate, selection, min_value
    and s_K out — and recheck agrees with audit."""
    x = clustered_data
    q = x[7] + np.float32(0.02)
    ids, sc = _frontier(x, q, K, pad, metric)
    want = jth.theorem2_audit(x, metric, ids, sc, eps, k)
    got = tth.theorem2_audit(x, metric, ids, sc, eps, k, device="cpu")
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert (got[2], got[3]) == (want[2], want[3])
    cert, sel = tth.theorem2_recheck(torch.as_tensor(x), metric, ids, sc,
                                     eps, k)
    assert cert == got[0]
    np.testing.assert_array_equal(sel, got[1])


def test_theorem2_audit_refuses_empty_frontiers(clustered_data):
    for ids in (np.zeros(0, np.int32), np.full(4, -1, np.int32)):
        sc = np.full(ids.shape, -np.inf, np.float32)
        got = tth.theorem2_audit(clustered_data, "l2", ids, sc, 0.0, 3,
                                 device="cpu")
        want = jth.theorem2_audit(clustered_data, "l2", ids, sc, 0.0, 3)
        assert got[0] is False and (got[2], got[3]) == (want[2], want[3])
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))


def test_slack_threshold_and_recall_bound_match_reference():
    for slack in (-1.0, 0.0, 1e-6, 0.5, 3.0, float("inf")):
        for k in (1, 3, 10):
            for lip in (1.0, 2.5):
                assert tth.theorem2_slack_threshold(slack, k, lip) \
                    == jth.theorem2_slack_threshold(slack, k, lip)
    for K, k, lam in ((10, 5, 0.1), (64, 10, 0.02), (3, 5, 0.1),
                      (40, 10, 0.9)):
        assert tth.theorem3_recall_bound(K, k, lam) \
            == jth.theorem3_recall_bound(K, k, lam)


# ------------------------------------------------------ cache unit tests ----

def _certified_result(k: int = 3) -> DiverseResult:
    stats = SearchStats(expansions=10, growths=0, search_calls=1,
                        div_calls=1, certified=True, exhausted=False,
                        K_final=k)
    sc = np.linspace(1.0, 0.5, k).astype(np.float32)
    return DiverseResult(np.arange(k, dtype=np.int32), sc, float(sc.sum()),
                         stats)


def _tiny_cache(capacity=2, **kw):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(16, 4)).astype(np.float32)
    return SemanticResultCache(X, "l2", capacity, device="cpu", **kw), rng


CAND = np.array([0, 1, 2, 3], np.int32)
SC = np.array([1.0, 0.9, 0.8, 0.7], np.float32)


def test_uncertified_or_frontierless_results_rejected():
    cache, rng = _tiny_cache()
    q = rng.normal(size=4).astype(np.float32)
    res = _certified_result()
    res.stats.certified = False
    good = _certified_result()
    assert not cache.admit_request(q, 3, 0.0, "pss", res, CAND, SC,
                                   slack=1.0)
    assert not cache.admit_request(q, 3, 0.0, "pss", good, None, None,
                                   slack=1.0)
    assert not cache.admit_request(q, 3, 0.0, "pss", good,
                                   np.full(4, -1, np.int32), SC, slack=1.0)
    assert not cache.admit_request(q, 3, 0.0, "pss", good, CAND, SC,
                                   slack=0.0)
    assert len(cache) == 0 and cache.rejected == 4 and cache.admitted == 0


def test_slack_aware_lru_eviction():
    """A narrow-slack newcomer never displaces wide-slack residents."""
    cache, rng = _tiny_cache(capacity=2)

    def admit(slack):
        q = rng.normal(size=4).astype(np.float32)
        return cache.admit_request(q, 3, 0.0, "pss", _certified_result(),
                                   CAND, SC, slack=slack)

    assert admit(2.0) and admit(4.0)
    assert not admit(0.4)
    assert len(cache) == 2 and cache.evicted == 0 and cache.rejected == 1
    assert admit(3.0)
    assert cache.evicted == 1
    assert sorted(e.slack for e in cache._entries.values()) == [3.0, 4.0]


def test_k1_infinite_slack_capped_by_max_drift():
    cache, rng = _tiny_cache(capacity=4, max_drift=0.05)
    q = rng.normal(size=4).astype(np.float32)
    sc = query_sim(torch.as_tensor(q), torch.as_tensor(cache.vectors),
                   "l2").numpy()
    order = np.argsort(-sc, kind="stable")[:6].astype(np.int32)
    stats = SearchStats(expansions=1, growths=0, search_calls=1, div_calls=1,
                        certified=True, exhausted=False, K_final=6)
    res = DiverseResult(order[:1], sc[order[:1]], float(sc[order[0]]), stats)
    assert cache.admit_request(q, 1, 0.0, "pss", res, order, sc[order])
    assert next(iter(cache._entries.values())).threshold == np.inf
    hit = cache.lookup(q, 1, 0.0, "pss")
    assert hit is not None and int(hit[0].ids[0]) == int(order[0])
    delta = rng.normal(size=4)
    delta = (delta / np.linalg.norm(delta) * 0.2).astype(np.float32)
    assert cache.lookup(q + delta, 1, 0.0, "pss") is None


def test_key_mismatch_never_hits_and_invalidate():
    cache, rng = _tiny_cache(capacity=4)
    q = rng.normal(size=4).astype(np.float32)
    assert cache.admit_request(q, 3, 0.5, "pss", _certified_result(),
                               CAND, SC, slack=10.0)
    assert cache.lookup(q, 2, 0.5, "pss") is None
    assert cache.lookup(q, 3, 0.6, "pss") is None
    assert cache.lookup(q, 3, 0.5, "pds") is None
    assert cache.lookup(q, 3, 0.5, "pss") is not None
    assert cache.invalidate([9, 10]) == 0
    assert cache.invalidate([2]) == 1 and len(cache) == 0


def test_for_backend_refuses_missing_corpus():
    class Bare:
        pass
    with pytest.raises(ValueError, match="float corpus"):
        SemanticResultCache.for_backend(Bare())
