"""Elastic resharding (contract 16) on the CPU: repro_torch against
repro.distributed.elastic / repro.sharded_search, case for case with
``tests/test_elastic.py``.

Both packages run without a mesh: ``reshard_tree`` / ``reshard_index`` take
a bare ``shards=`` count and ``migrate_sharded_state`` needs none. The
reference's index is carried into the port with ``index_from_host``, so
both reshard the same shards and each rebuilds the new shards' graphs with
its own builder (on tie-free Gaussian rows the two give the same
neighbours, ``test_torch_graph_build.py``); every leaf must be equal. A
migrated state must equal the reference's leaf for leaf, bit for bit,
``-inf`` / ``True`` / ``-1`` padding included.
"""
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.distributed import elastic as jel
from repro.sharded_search import search as jss
from repro_torch import compat
from repro_torch.distributed import elastic as tel
from repro_torch.sharded_search import search as tss

torch.set_num_threads(1)

LEAVES = ("vectors", "neighbors", "entries", "bases", "codes", "scales",
          "codebooks")


def _host(idx) -> dict:
    """A reference or port index as numpy leaves plus its static fields."""
    host = {f: (None if getattr(idx, f) is None
                else (getattr(idx, f).cpu().numpy()
                      if isinstance(getattr(idx, f), torch.Tensor)
                      else np.asarray(getattr(idx, f)))) for f in LEAVES}
    return dict(host, metric=idx.metric, scheme=idx.scheme,
                scale_rows=int(idx.scale_rows))


def _assert_index_equal(a, b):
    a, b = _host(a), _host(b)
    for f in ("metric", "scheme", "scale_rows"):
        assert a[f] == b[f], f
    for f in LEAVES:
        assert (a[f] is None) == (b[f] is None), f
        if a[f] is not None:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _assert_state_equal(got, ref):
    for name in tss.ShardedSearchState._fields:
        g = getattr(got, name)
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype and g.shape == r.shape, name
        # bit for bit: -0.0 beside +0.0 and every -inf pad
        np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8),
                                      err_msg=name)


def _corpus(seed, n=128, d=8):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _carry(jidx):
    return tss.index_from_host(_host(jidx), device="cpu")


def _rand_state(rng, p, B, C, ns, ties=False):
    """A synthetic in-flight state obeying the queue conventions (each
    (shard, lane) queue sorted by score desc, global id asc; empty slots
    (-1, -inf, True)) as numpy leaves. ``ties`` draws scores from a few
    values, -0.0 and +0.0 among them."""
    ids = np.full((p, B, C), -1, np.int32)
    scores = np.full((p, B, C), -np.inf, np.float32)
    stable = np.ones((p, B, C), bool)
    for s in range(p):
        for b in range(B):
            m = int(rng.integers(0, min(C, ns) + 1))
            loc = rng.choice(ns, size=m, replace=False)
            if ties:
                sc = rng.choice(np.array([1.5, 0.0, -0.0, -2.0], np.float32),
                                size=m)
            else:
                sc = rng.normal(size=m).astype(np.float32)
            order = np.lexsort((loc + s * ns, -sc))
            ids[s, b, :m] = loc[order].astype(np.int32)
            scores[s, b, :m] = sc[order]
            stable[s, b, :m] = rng.random(m) < 0.5
    return dict(ids=ids, scores=scores, stable=stable,
                visited=rng.random((p, B, ns)) < 0.3,
                steps=rng.integers(0, 50, size=(p, B)).astype(np.int32))


def _states(host):
    """The same state for the reference (numpy leaves) and the port."""
    return (jss.ShardedSearchState(**host),
            tss.state_from_host(host, device="cpu"))


# -- reshard_tree / reshard_index ------------------------------------------


@given(st.integers(0, 10_000))
@settings(max_examples=4, deadline=None)
def test_reshard_tree_index_roundtrip_bit_identical(seed):
    """4 -> 8 -> 4 gives the original index back leaf for leaf, float, int8
    and PQ alike; each step equals the reference's reshard of the same
    shards."""
    x = _corpus(seed)
    for quantized in (None, "int8", "pq"):
        jidx4 = jss.build_sharded_index(x, 4, "l2", M=4, quantized=quantized,
                                        scale_rows=2, pq_m=4)
        idx4 = _carry(jidx4)
        av = x if quantized else None
        idx8 = tel.reshard_tree(idx4, shards=8, all_vectors=av)
        assert idx8.num_shards == 8 and idx8.shard_size == 16
        _assert_index_equal(idx8, jel.reshard_tree(jidx4, shards=8,
                                                   all_vectors=av))
        back = tel.reshard_tree(idx8, shards=4, all_vectors=av)
        _assert_index_equal(idx4, back)
    # the port's own build round-trips too
    own = tss.build_sharded_index(x, 4, "l2", M=4, device="cpu")
    _assert_index_equal(own, tss.reshard_index(
        tss.reshard_index(own, 2), 4))


@given(st.integers(0, 10_000))
@settings(max_examples=4, deadline=None)
def test_reshard_quantized_codes_scales_exact(seed):
    """A quantized reshard re-blocks the code rows and scale blocks byte
    for byte — nothing is quantized again — and PQ codebooks are shared."""
    x = _corpus(seed)
    i8 = tss.build_sharded_index(x, 4, "l2", M=4, quantized="int8",
                                 scale_rows=2, device="cpu")
    i8r = tss.reshard_index(i8, 8, x)
    np.testing.assert_array_equal(i8.codes.reshape(len(x), -1),
                                  i8r.codes.reshape(len(x), -1))
    np.testing.assert_array_equal(i8.scales.reshape(-1),
                                  i8r.scales.reshape(-1))
    jpq = jss.build_sharded_index(x, 4, "l2", M=4, quantized="pq", pq_m=4)
    pq = _carry(jpq)
    pqr = tss.reshard_index(pq, 2, x)
    np.testing.assert_array_equal(pq.codes.reshape(len(x), -1),
                                  pqr.codes.reshape(len(x), -1))
    assert pqr.codebooks is pq.codebooks
    _assert_index_equal(pqr, jss.reshard_index(jpq, 2, x))


def test_reshard_index_validation():
    x = _corpus(0, n=64)
    idx = tss.build_sharded_index(x, 4, "l2", M=4, device="cpu")
    with pytest.raises(ValueError):
        tss.reshard_index(idx, 3, x)                # not a power of two
    with pytest.raises(ValueError):
        tss.reshard_index(idx, 128, x)              # rows don't divide
    i8 = tss.build_sharded_index(x, 4, "l2", M=4, quantized="int8",
                                 scale_rows=16, device="cpu")
    with pytest.raises(ValueError):
        tss.reshard_index(i8, 8, x)                 # scale blocks would split
    with pytest.raises(ValueError):
        tss.reshard_index(i8, 2, None)              # quantized needs floats
    assert tss.reshard_index(idx, 4, x) is idx      # same count: no-op
    with pytest.raises(ValueError):
        tel.reshard_tree(idx)                       # needs mesh or shards=
    with pytest.raises(ValueError, match="unknown builder"):
        tss.reshard_index(idx, 2, builder="nsg")
    with pytest.raises(NotImplementedError, match="queue 1 G"):
        tel.reshard_tree({"w": torch.zeros(2)}, shards=2, cfg=object())


@pytest.mark.parametrize("quantized", [None, "int8"])
def test_reshard_index_hnsw_matches_reference(quantized):
    """``builder="hnsw"``: each new shard's HNSW graph (level 0 and entry)
    is the reference's, bit for bit, float and int8 alike, and a round trip
    gives the original index back."""
    x = _corpus(3, n=256, d=8)
    jidx = jss.build_sharded_index(x, 4, "l2", M=4, builder="hnsw",
                                   quantized=quantized, scale_rows=2)
    idx = tss.build_sharded_index(x, 4, "l2", M=4, builder="hnsw",
                                  quantized=quantized, scale_rows=2,
                                  device="cpu")
    _assert_index_equal(idx, jidx)
    idx2 = tss.reshard_index(idx, 2, x, builder="hnsw")
    _assert_index_equal(idx2, jss.reshard_index(jidx, 2, x, builder="hnsw"))
    _assert_index_equal(idx, tss.reshard_index(idx2, 4, x, builder="hnsw"))


def test_reshard_tree_reads_the_mesh():
    """With a mesh and no ``shards=``, the target count is the mesh's size
    along ``axis``; the state's migration checks the mesh."""
    x = _corpus(1, n=64)
    idx = tss.build_sharded_index(x, 2, "l2", M=4, device="cpu")
    mesh4 = compat.make_mesh((4,), ("data",), device="cpu")
    idx4 = tel.reshard_tree(idx, mesh4)
    assert idx4.num_shards == 4
    state = tss.init_sharded_state(idx, 2, 32)
    assert tel.reshard_tree(state, mesh4, capacity=16).ids.shape == (4, 2, 16)
    with pytest.raises(ValueError):
        tss.migrate_sharded_state(state, 2, mesh=mesh4)


# -- plan ------------------------------------------------------------------


@given(st.integers(0, 3), st.integers(0, 3), st.integers(0, 2),
       st.integers(0, 2))
@settings(max_examples=30, deadline=None)
def test_plan_inverses(d0, d1, m0, m1):
    def stubs(sizes: dict):
        port = types.SimpleNamespace(axis_names=tuple(sizes),
                                     shape=tuple(sizes.values()))
        ref = types.SimpleNamespace(axis_names=tuple(sizes),
                                    devices=np.zeros(tuple(sizes.values())))
        return port, ref

    (a, ja), (b, jb) = (stubs({"data": 2 ** d0, "model": 2 ** m0}),
                        stubs({"data": 2 ** d1, "model": 2 ** m1}))
    fwd, rev = tel.plan(a, b), tel.plan(b, a)
    assert fwd == jel.plan(ja, jb) and rev == jel.plan(jb, ja)
    assert fwd["old"] == rev["new"] and fwd["new"] == rev["old"]
    assert fwd["dp_change"] == 2.0 ** (d1 - d0)
    assert fwd["tp_change"] == 2.0 ** (m1 - m0)
    for ax, r in fwd["axis_changes"].items():
        assert rev["axis_changes"][ax] == pytest.approx(1.0 / r)
    mesh = compat.make_mesh((4,), ("data",), device="cpu")
    assert tel.plan(mesh, compat.make_mesh((2,), ("data",), device="cpu")
                    )["dp_change"] == 0.5


# -- migrate_sharded_state -------------------------------------------------


@given(st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_migrate_state_roundtrip_bit_identical(seed):
    """Grow 4 -> 8, then shrink back: each step equals the reference's
    leaf for leaf, and the round trip gives the state back; each lane's
    step total rides through both."""
    rng = np.random.default_rng(seed)
    j4, t4 = _states(_rand_state(rng, p=4, B=3, C=8, ns=32))
    t8 = tss.migrate_sharded_state(t4, 8)
    j8 = jss.migrate_sharded_state(j4, 8)
    _assert_state_equal(t8, j8)
    back = tss.migrate_sharded_state(t8, 4)
    _assert_state_equal(back, jss.migrate_sharded_state(j8, 4))
    _assert_state_equal(back, j4)
    tot = t4.steps.sum(dim=0)
    assert torch.equal(t8.steps.sum(dim=0), tot)


@given(st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_migrate_state_preserves_entries_and_visited(seed):
    """Every (global id, score, stable) entry and every visited global row
    survives a grow and a merging shrink, each equal to the reference's."""
    rng = np.random.default_rng(seed)
    p, ns = 4, 32
    j, t = _states(_rand_state(rng, p=p, B=2, C=8, ns=ns))
    for p_new in (8, 2):
        cap = 8 * max(1, p // p_new)     # a shrink merges queues
        out = tss.migrate_sharded_state(t, p_new, capacity=cap)
        _assert_state_equal(out, jss.migrate_sharded_state(j, p_new,
                                                           capacity=cap))
        ns_new = p * ns // p_new
        for b in range(2):
            def entries(state, width):
                ids, sc, stbl = (a.cpu().numpy() for a in state[:3])
                return {(int(ids[s, b, c]) + s * width, float(sc[s, b, c]),
                         bool(stbl[s, b, c]))
                        for s in range(ids.shape[0])
                        for c in range(ids.shape[2]) if ids[s, b, c] >= 0}
            assert entries(t, ns) == entries(out, ns_new)
            assert torch.equal(t.visited[:, b].reshape(-1),
                               out.visited[:, b].reshape(-1))


@given(st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_migrate_state_ties_and_signed_zeros(seed):
    """Equal scores (-0.0 beside +0.0 among them) order by global id, as
    the reference's lexsort orders them."""
    rng = np.random.default_rng(seed)
    j, t = _states(_rand_state(rng, p=4, B=3, C=8, ns=16, ties=True))
    for p_new, cap in ((2, 16), (1, 32), (8, 8)):
        _assert_state_equal(
            tss.migrate_sharded_state(t, p_new, capacity=cap),
            jss.migrate_sharded_state(j, p_new, capacity=cap))


@given(st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_migrate_state_lane_scaling(seed):
    """``num_lanes`` appends empty lanes on a grow and keeps the surviving
    prefix verbatim on a shrink, as the reference does."""
    rng = np.random.default_rng(seed)
    j, t = _states(_rand_state(rng, p=2, B=2, C=8, ns=32))
    wide = tss.migrate_sharded_state(t, 4, num_lanes=4)
    _assert_state_equal(wide, jss.migrate_sharded_state(j, 4, num_lanes=4))
    assert wide.ids.shape[1] == 4
    assert (wide.ids[:, 2:] == -1).all() and not wide.visited[:, 2:].any()
    assert (wide.steps[:, 2:] == 0).all()
    back = tss.migrate_sharded_state(wide, 2, capacity=8, num_lanes=2)
    _assert_state_equal(back, j)


def test_migrate_state_capacity_overflow_raises():
    """A shrink that would merge more entries than the target queue holds
    refuses (dropping them would void the widening contract); it succeeds
    once the capacity is sized up."""
    rng = np.random.default_rng(0)
    p, B, C, ns = 4, 2, 8, 64
    ids = np.zeros((p, B, C), np.int32)
    scores = np.zeros((p, B, C), np.float32)
    for s in range(p):
        for b in range(B):
            loc = rng.choice(ns, size=C, replace=False)
            sc = rng.normal(size=C).astype(np.float32)
            order = np.lexsort((loc + s * ns, -sc))
            ids[s, b] = loc[order]
            scores[s, b] = sc[order]
    host = dict(ids=ids, scores=scores, stable=np.ones((p, B, C), bool),
                visited=np.zeros((p, B, ns), bool),
                steps=np.zeros((p, B), np.int32))
    j, t = _states(host)
    with pytest.raises(ValueError, match="capacity"):
        tss.migrate_sharded_state(t, 2)
    out = tss.migrate_sharded_state(t, 2, capacity=16)
    assert out.ids.shape == (2, 2, 16)
    _assert_state_equal(out, jss.migrate_sharded_state(j, 2, capacity=16))
    with pytest.raises(ValueError):
        tss.migrate_sharded_state(t, 3)


# -- protocol / facade gates ----------------------------------------------


def test_rescalable_protocol_detection():
    """The scheduler's elastic trigger feature-detects RescalableBackend:
    the single-host engine, bare or wrapped, is not one, and elastic= over
    it is refused; the sharded engine is one, bare and wrapped."""
    from repro_torch.core.backend import LaneBackend, RescalableBackend
    from repro_torch.core.batch_progressive import ProgressiveEngine
    from repro_torch.index.flat import build_knn_graph
    from repro_torch.index.mutable import (MutableBackend, MutableIndex,
                                           RescalableMutableBackend)
    from repro_torch.serve.scheduler import LaneScheduler
    from repro_torch.sharded_search.engine import ShardedEngine

    x = _corpus(1, n=64)
    eng = ProgressiveEngine(build_knn_graph(x, metric="l2", M=4,
                                            device="cpu"), 2, max_k=4)
    assert not isinstance(eng, RescalableBackend)
    mi = MutableIndex(x, "l2", M=4, device="cpu")
    wrapped = MutableBackend(ProgressiveEngine(mi.graph, 2, max_k=4), mi)
    assert type(wrapped) is MutableBackend
    assert not isinstance(wrapped, RescalableBackend)
    with pytest.raises(ValueError, match="elastic"):
        LaneScheduler(backend=wrapped, prewarm=False, elastic=True)
    ms = MutableIndex(x, "l2", M=4, shards=2, device="cpu")
    sh = ShardedEngine(ms.sharded, ms.float_view(),
                       compat.make_mesh((2,), ("data",), device="cpu"), 2,
                       max_k=4)
    assert isinstance(sh, RescalableBackend)
    wrapped = MutableBackend(sh, ms)
    assert type(wrapped) is RescalableMutableBackend
    assert isinstance(wrapped, LaneBackend)
    assert isinstance(wrapped, RescalableBackend)
    assert wrapped.num_shards == 2 and wrapped.rescale_options() == (2,)


def test_db_shards_auto_and_elastic_resolution():
    """``compat.device_count()`` is the mesh's 4 virtual shard slots:
    ``shards="auto"`` resolves to 4, and under ``elastic=`` to 2 with the
    4-shard target prepared, the corpus padded to divisibility by 4."""
    from repro_torch.core.backend import RescalableBackend
    from repro_torch.db import DiverseVectorDB

    assert compat.device_count() == compat.LOCAL_DEVICE_COUNT == 4
    x = _corpus(2, n=62)
    kw = dict(M=4, num_lanes=2, max_k=4, prewarm=False, device="cpu")
    db = DiverseVectorDB(x, "l2", shards="auto", **kw)
    assert db.backend.num_shards == 4 and db.backend.rescale_options() == (4,)
    assert db.index.n_total == 64 and db.index.num_deleted == 2
    r = db.search(x[3], k=3, eps=2.0)
    assert r.stats.certified and 62 not in r.ids and 63 not in r.ids
    db = DiverseVectorDB(x, "l2", shards="auto", elastic=True,
                         backend_kw=dict(K0=8), **kw)
    assert isinstance(db.backend, RescalableBackend)
    assert db.backend.num_shards == 2
    assert db.backend.rescale_options() == (2, 4)
    assert db.index.n_total == 64
    assert db.scheduler.latency_stats()["shards"] == 2
    with pytest.raises(ValueError, match="standard targets"):
        DiverseVectorDB(x, "l2", shards=1, elastic=True, **kw)
    with pytest.raises(ValueError, match="sharded backend"):
        DiverseVectorDB(x, "l2", elastic=True, **kw)
