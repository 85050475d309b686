"""The facade and the write path: repro_torch.db.DiverseVectorDB and
repro_torch.index.mutable against repro.db / repro.index.mutable, on the CPU
with the reference at its default rung ("ref" off a TPU).

Both packages build their own KNN graph over the same rows (on tie-free
data the two builders give the same neighbours, test_torch_graph_build.py),
so a seeded sequence of reads, upserts, deletes and rebuilds must give the
same ids, certificates and (epoch, version) tags in both; scores within
rtol = atol = 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import db as jdb
from repro.core import theorems as jth
from repro.core.graph import to_host
from repro_torch import db as tdb
from repro_torch.core import batch_progressive as tbp
from repro_torch.core import theorems as tth
from repro_torch.core.backend import LaneBackend, RescalableBackend
from repro_torch.core.graph import from_host
from repro_torch.core.similarity import query_sim
from repro_torch.index.mutable import DeltaFull, MutableBackend, MutableIndex
from repro_torch.serve.scheduler import LaneScheduler

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

def _db(pkg, x, **kw):
    kw = dict(dict(metric="l2", M=8, num_lanes=3, max_k=8, default_ef=12,
                   prewarm=False), **kw)
    if pkg is tdb:
        kw["device"] = "cpu"
    return pkg.DiverseVectorDB(x, **kw)


def _queries(x, num, seed):
    rng = np.random.default_rng(seed)
    return (x[rng.integers(0, len(x), num)]
            + 0.05 * rng.normal(size=(num, x.shape[1]))).astype(np.float32)


def _submit(pkg, db, q, reqs):
    while True:
        try:
            reqs.append(db.scheduler.submit(q))
            return
        except (pkg.SchedulerSaturated, pkg.RequestDeferred):
            db.scheduler.pump()


def _poll(db, reqs, metas, frontiers):
    """Capture each completed request's harvest-time snapshot tag and merged
    frontier (a lane's slots hold until its next harvest, so polling after
    every pump sees them first)."""
    for r in reqs:
        if (r.result is not None and r.lane is not None
                and id(r) not in metas):
            metas[id(r)] = db.backend.last_meta[r.lane]
            frontiers[id(r)] = db.backend.last_candidates[r.lane]


def _straddle(pkg, th, x):
    """Contract 15 on the single-host engine (the reference's
    ``test_epoch_swap_straddle_flat``): upserts / deletes interleave with
    in-flight multi-round lanes; the delta fills mid-run and the rebuilt
    graph swaps in between rounds. Every result must be valid against
    exactly one corpus version, and every certified lane must pass an
    independent Theorem-2 recheck of its merged frontier. Returns the
    outcome for the cross-package comparison."""
    Query = pkg.Query
    rng = np.random.default_rng(3)
    db = _db(pkg, x, delta_capacity=8, background_rebuild=False)
    qs = (x[rng.integers(0, len(x), 12)]
          + 0.05 * rng.normal(size=(12, x.shape[1]))).astype(np.float32)
    snaps = {}

    def snap():
        snaps[db.index.version] = (db.index.n_total,
                                   db.index.deleted.copy())

    snap()
    reqs, metas, frontiers = [], {}, {}
    for i in range(6):
        _submit(pkg, db, Query(qs[i], k=5, eps=0.0, ef=12), reqs)
    db.scheduler.pump()
    _poll(db, reqs, metas, frontiers)
    assert db.scheduler.inflight or db.scheduler.pending
    db.upsert(qs[:3] + np.float32(0.01))
    snap()
    db.delete([17, 23])
    snap()
    for i in range(6, 9):
        _submit(pkg, db, Query(qs[i], k=5, eps=0.0, ef=12), reqs)
    db.scheduler.pump()
    _poll(db, reqs, metas, frontiers)
    db.upsert(rng.normal(size=(6, x.shape[1])).astype(np.float32))
    snap()
    assert db.index.swap_ready()            # the inline rebuild is ready
    for i in range(9, 12):
        _submit(pkg, db, Query(qs[i], k=5, eps=0.0, ef=12), reqs)
    while any(r.result is None for r in reqs):
        db.scheduler.pump()
        _poll(db, reqs, metas, frontiers)
    assert db.backend.swaps == 1 and db.index.epoch == 1
    epochs = set()
    for r in reqs:
        meta = metas[id(r)]
        epochs.add(meta["epoch"])
        v = max(ver for ver in snaps if ver <= meta["version"])
        n_at, dele_at = snaps[v]
        ids = np.asarray(r.result.ids)
        ids = ids[ids >= 0]
        assert ids.size and (ids < n_at).all()
        assert not dele_at[ids].any()
        assert not {17, 23}.intersection(ids.tolist())
        if r.result.stats.certified:
            m_ids, m_sc = frontiers[id(r)][0], frontiers[id(r)][1]
            ok, sel = th.theorem2_recheck(
                db.index.float_view()[:n_at], "l2", m_ids, m_sc, 0.0, 5,
                **({"device": "cpu"} if th is tth else {}))
            assert ok and np.array_equal(np.asarray(sel),
                                         np.asarray(r.result.ids))
    assert epochs == {0, 1}
    assert any(r.result.stats.certified for r in reqs)
    last = db.search(Query(qs[0], k=5, eps=0.0, ef=12))
    assert 600 in np.asarray(last.ids).tolist()   # upserted near-dup
    return ([(np.asarray(r.result.ids).tolist(),
              bool(r.result.stats.certified),
              (metas[id(r)]["epoch"], metas[id(r)]["version"]))
             for r in reqs], np.asarray(last.ids).tolist())


def test_epoch_swap_straddle_flat(clustered_data):
    """The reference's straddle scenario, run in both packages: each holds
    contract 15, and both serve the same ids, certificates and tags."""
    got = _straddle(tdb, tth, clustered_data)
    want = _straddle(jdb, jth, clustered_data)
    assert got == want


def _sequence(pkg, x):
    """Seeded reads, upserts, deletes and a forced rebuild through the
    facade with the cache on; every result with its (epoch, version)."""
    Query = pkg.Query
    qs = _queries(x, 9, seed=21)
    db = _db(pkg, x, delta_capacity=64, background_rebuild=False,
             cache_size=16)
    out = []

    def serve():
        reqs, metas, frontiers = [], {}, {}
        for i, q in enumerate(qs):
            _submit(pkg, db, Query(q, k=(5, 3)[i % 2],
                                   eps=(0.0, -0.5)[i % 2]), reqs)
        while any(r.result is None for r in reqs):
            db.scheduler.pump()
            _poll(db, reqs, metas, frontiers)
        for r in reqs:
            tag = metas.get(id(r))
            out.append((np.asarray(r.result.ids).tolist(),
                        np.asarray(r.result.scores),
                        bool(r.result.stats.certified), r.cache_hit,
                        None if tag is None else (tag["epoch"],
                                                  tag["version"])))

    serve()
    serve()                       # exact duplicates: the cache's hits
    first = out[0][0]
    db.upsert(qs[:3] + np.float32(0.01))
    db.delete([first[0], first[1], 17])
    serve()
    assert db.rebuild(wait=True)
    serve()
    st = db.stats()
    out.append((st["epoch_swaps"], st["index"]["version"],
                st["index"]["deleted"], st["cache_hits"],
                st["cache_invalidations"]))
    return out


def test_write_sequence_matches_reference(clustered_data):
    got = _sequence(tdb, clustered_data)
    want = _sequence(jdb, clustered_data)
    assert got[-1] == want[-1]
    assert got[-1][0] == 1 and got[-1][3] > 0
    for g, w in zip(got[:-1], want[:-1]):
        assert (g[0], g[2], g[3], g[4]) == (w[0], w[2], w[3], w[4])
        np.testing.assert_allclose(g[1], w[1], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def port_db(small_graph):
    return tdb.DiverseVectorDB(
        index=from_host(to_host(small_graph), device="cpu"), num_lanes=3,
        max_k=8, default_ef=10, prewarm=False, device="cpu")


def test_search_matches_solo_engine(port_db, clustered_data):
    """With no writes the facade is a pass-through: each result equals the
    lockstep engine's lane for that query, bit for bit."""
    qs = _queries(clustered_data, 6, seed=0)
    for i, (k, eps) in enumerate([(5, 0.0), (3, -0.5)] * 3):
        r = port_db.search(qs[i], k=k, eps=eps, ef=10)
        solo = tbp.batch_pss(port_db.index.graph, qs[i:i + 1], k, eps, ef=10)
        np.testing.assert_array_equal(r.ids, solo.ids[0])
        np.testing.assert_array_equal(r.scores, solo.scores[0])
        assert r.stats.certified == bool(solo.stats.certified[0])
        assert r.stats.K_final == int(solo.stats.K_final[0])


def test_search_batch_and_query_validation(port_db, clustered_data):
    qs = clustered_data[:4] + np.float32(0.01)
    by_arr = port_db.search_batch(qs, k=3, eps=0.0, ef=10)
    by_query = port_db.search_batch(
        [tdb.Query(q, k=3, eps=0.0, ef=10) for q in qs])
    for a, b in zip(by_arr, by_query):
        np.testing.assert_array_equal(a.ids, b.ids)
    q = tdb.Query(np.zeros(24, np.float32), k=3, eps=0.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        q.k = 5
    with pytest.raises(ValueError):
        port_db.search(q, k=5)
    with pytest.raises(TypeError):
        port_db.search(np.zeros(24, np.float32))
    with pytest.raises(TypeError):
        tdb.Query("what is diversity?", k=3, eps=0.0).embedding()


def test_text_queries_and_upsert_delete(clustered_data):
    emb = {"a": clustered_data[3]}
    db = _db(tdb, clustered_data, num_lanes=2, embed=lambda t: emb[t])
    r = db.search("a", k=3, eps=0.0, ef=10)
    assert 3 in r.ids.tolist()
    q = (clustered_data[11] + 0.05 * np.random.default_rng(4).normal(
        size=24)).astype(np.float32)
    ids = db.upsert(q[None])
    assert int(ids[0]) == len(clustered_data)
    assert int(ids[0]) in db.search(q, k=3, eps=0.0, ef=10).ids.tolist()
    assert db.delete(ids) == 1
    assert int(ids[0]) not in db.search(q, k=3, eps=0.0, ef=10).ids.tolist()
    st = db.stats()
    assert st["writes"] == st["writes_applied"] == 2
    assert st["index"]["deleted"] == 1


def test_delta_full_backpressure(clustered_data):
    """Past four delta capacities with the rebuild not yet swapped in,
    upsert raises ``DeltaFull``; installing the rebuild accepts writes
    again."""
    idx = MutableIndex(clustered_data, "l2", M=8, delta_capacity=4,
                       background=False, device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(16):
        idx.upsert(rng.normal(size=(1, 24)).astype(np.float32))
    assert idx.delta_count == 16
    with pytest.raises(DeltaFull):
        idx.upsert(rng.normal(size=(1, 24)).astype(np.float32))
    assert idx.swap_ready()
    idx.install_swap()
    assert idx.delta_count == 12 and idx.epoch == 1
    assert idx.graph.size == len(clustered_data) + 4
    idx.upsert(rng.normal(size=(1, 24)).astype(np.float32))
    with pytest.raises(KeyError):
        idx.delete([idx.n_total])
    assert idx.delete([3, 5]) == 2 and idx.delete([5, 7]) == 1


def test_delta_scores_bit_match_the_flat_scan(clustered_data):
    """Delta scoring is one flat scan: ids and scores equal the plain
    similarity over exactly the live tail rows."""
    x = clustered_data
    idx = MutableIndex(x, "l2", M=8, delta_capacity=64, background=False,
                       device="cpu")
    new = np.random.default_rng(1).normal(size=(7, 24)).astype(np.float32)
    ids = idx.upsert(new)
    q = x[0] + np.float32(0.01)
    d_ids, d_sc = idx.score_delta(q)
    want = query_sim(torch.as_tensor(q), torch.as_tensor(new), "l2").numpy()
    np.testing.assert_array_equal(d_ids, ids)
    np.testing.assert_array_equal(d_sc, want)
    idx.delete(ids[2:3])
    d_ids2, d_sc2 = idx.score_delta(q)
    keep = np.arange(7) != 2
    np.testing.assert_array_equal(d_ids2, ids[keep])
    np.testing.assert_array_equal(d_sc2, want[keep])


def test_mutable_backend_protocols(port_db, clustered_data):
    """The decorator defines every delegated member itself, so it is a
    LaneBackend under Python 3.12's static protocol check — a
    RescalableBackend over the sharded engine, and never one over the
    single-host engine, which has no rescale members."""
    backend = port_db.backend
    assert isinstance(backend, MutableBackend)
    assert isinstance(backend, LaneBackend)
    assert not isinstance(backend, RescalableBackend)
    assert isinstance(backend.inner, LaneBackend)
    assert backend.record_candidates and backend.inner.record_candidates
    with pytest.raises(ValueError, match="rescalable"):
        LaneScheduler(backend=backend, prewarm=False, elastic=True)
    sharded = _db(tdb, clustered_data, shards=2).backend
    assert isinstance(sharded, MutableBackend)
    assert isinstance(sharded, LaneBackend)
    assert isinstance(sharded, RescalableBackend)
    assert isinstance(sharded.inner, RescalableBackend)
    assert sharded.num_shards == 2 and sharded.rescale_options() == (2,)


@pytest.mark.parametrize("kw,item", [
    (dict(quantized="int8"), "queue 1 H"), (dict(builder="hnsw"),
                                            "queue 1 F")])
def test_unported_branches_raise(clustered_data, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        tdb.DiverseVectorDB(clustered_data, "l2", prewarm=False,
                            device="cpu", **kw)
    with pytest.raises(NotImplementedError, match=item):
        MutableIndex(clustered_data, "l2", background=False,
                     device="cpu", **kw)


def test_write_admission_validates(port_db):
    with pytest.raises(ValueError):
        port_db.scheduler.submit_write("replace", [0])
    plain = LaneScheduler(port_db.index.graph, num_lanes=2, max_k=8,
                          default_ef=10, prewarm=False, device="cpu")
    with pytest.raises(TypeError):
        plain.submit_write("upsert", np.zeros((1, 24), np.float32))
