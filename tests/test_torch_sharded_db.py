"""The sharded facade and elastic rescaling: repro_torch against the
reference on the CPU, with the reference in three subprocesses of four
forced host devices each (as ``tests/dist_scripts/*`` run it).

The drivers below run unchanged in both packages (``_pkg`` gathers each
one's names):

* ``facade_reads`` — ``DiverseVectorDB(shards=4)``, float and int8, over the
  same rows with no write. Each package builds its own shard graphs (on
  tie-free Gaussian rows the builders agree, ``test_torch_graph_build.py``).
* ``mutable_straddle`` — contract 15 on the sharded facade, the shape of
  ``tests/dist_scripts/mutable_straddle_check.py`` (N = 1024, d = 16, ``ip``):
  writes land while multi-round lanes run, the delta fills, the rebuilt
  sharded index swaps in between rounds.
* ``engine_straddle`` / ``elastic_scheduler`` — part 1 of
  ``tests/dist_scripts/elastic_scale_check.py`` (N = 2048, d = 16, ``ip``):
  lanes admitted on 2 shards straddle a grow to 4 and a shrink back, then
  ``LaneScheduler(backend=ShardedEngine(...), elastic=policy)`` under a
  burst. The reference's 2- and 4-shard indexes are carried across with
  ``index_from_host``, so both packages serve the same graphs after every
  reshard.

Ids, certificates, K_final, epochs and scale events must be equal; scores
within 1e-5. The reference's own facade cannot take ``elastic=`` under
Python 3.12 (its ``MutableBackend`` reaches the rescale members through
``__getattr__``), so the port's elastic facade is held to the port's
bare-engine scheduler on the same indexes instead.

The same drivers also run over a process group (``rank_run``): four gloo
ranks (``tests/torch_dist_ranks.sharded_db_rank``), started with the
reference's subprocesses, serve each facade one shard per rank (rank 0
drives, the others follow inside their constructors, ``rank_pkg``); the
engine-direct straddles run rank 0's engine under ``RankZeroBackend``.
Every rank-0 result must equal the ``LocalMesh`` run's bit for bit (ids,
score bits, certificates, ``K_final``, expansions, epochs, versions, scale
events and the pumps they land at), and so the reference's. One more run
rebuilds in the background over the ranks and is held to the validity
gates, with exactly one swap on every rank.
"""
import functools
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ATOL = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
LEAVES = ("vectors", "neighbors", "entries", "bases", "codes", "scales",
          "codebooks")
K, EPS = 5, 4.0
POLICY = dict(grow_depth=2, shrink_depth=0, sustain=2, shrink_sustain=3,
              cooldown=3)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _host(idx) -> dict:
    host = {f: (None if getattr(idx, f) is None else _np(getattr(idx, f)))
            for f in LEAVES}
    return dict(host, metric=idx.metric, scheme=idx.scheme,
                scale_rows=int(idx.scale_rows))


def _res(r) -> dict:
    return dict(ids=np.asarray(r.ids), scores=np.asarray(r.scores),
                certified=bool(r.stats.certified),
                K_final=int(r.stats.K_final),
                expansions=int(r.stats.expansions),
                rounds=int(r.stats.search_calls))


def _pkg(name: str, device: str = "cpu"):
    """The names the drivers use, from ``repro`` or ``repro_torch`` (the
    port's entry points told to run on ``device``, the CPU unless
    given)."""
    if name == "repro":
        import jax.numpy as jnp

        from repro import db
        from repro.compat import make_mesh
        from repro.core.backend import LaneRequest
        from repro.core.theorems import theorem2_recheck
        from repro.serve import scheduler
        from repro.sharded_search import engine, search

        def sds(idx, x, qs, *a):
            return search.sharded_diverse_search(idx, jnp.asarray(x),
                                                 jnp.asarray(qs), *a)
        dbcls, recheck = db.DiverseVectorDB, theorem2_recheck
    else:
        from repro_torch import compat, db
        from repro_torch.core.backend import LaneRequest
        from repro_torch.core.theorems import theorem2_recheck
        from repro_torch.serve import scheduler
        from repro_torch.sharded_search import engine, search

        make_mesh = functools.partial(compat.make_mesh, device=device)
        sds = search.sharded_diverse_search
        dbcls = functools.partial(db.DiverseVectorDB, device=device)
        recheck = functools.partial(theorem2_recheck, device=device)
    return types.SimpleNamespace(
        DiverseVectorDB=dbcls, Query=db.Query, make_mesh=make_mesh,
        LaneRequest=LaneRequest, recheck=recheck, sds=sds,
        ShardedEngine=engine.ShardedEngine, LANE_RUN=engine.LANE_RUN,
        LaneScheduler=scheduler.LaneScheduler,
        ElasticPolicy=scheduler.ElasticPolicy,
        busy=(scheduler.SchedulerSaturated, scheduler.RequestDeferred),
        build_sharded_index=(search.build_sharded_index if name == "repro"
                             else functools.partial(
                                 search.build_sharded_index, device=device)),
        reshard_index=search.reshard_index)


def _world(n):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    return rng, x


# ---------------------------------------------------------- drivers ----

def facade_reads(ns, quantized):
    """Eight reads through a 4-shard facade with no write."""
    rng, x = _world(1024)
    qs = (x[rng.integers(0, len(x), 8)]
          + 0.05 * rng.normal(size=(8, 16))).astype(np.float32)
    db = ns.DiverseVectorDB(x, "ip", shards=4, quantized=quantized,
                            num_lanes=3, max_k=8, default_ef=12, M=8,
                            prewarm=False)
    return [_res(r) for r in db.search_batch([ns.Query(q, k=K, eps=EPS)
                                              for q in qs])]


def mutable_straddle(ns, background=False):
    """Contract 15 on the 4-shard facade: every result valid against the
    corpus version it is tagged with, no deleted id served, every certified
    frontier re-proved, results from epochs 0 and 1. With ``background``
    the rebuild runs on a thread; the driver waits for it before the last
    two requests, so they are served on the new epoch."""
    rng, x = _world(1024)
    db = ns.DiverseVectorDB(x, "ip", shards=4, num_lanes=3, max_k=8,
                            default_ef=12, M=8, delta_capacity=8,
                            background_rebuild=background, prewarm=False)
    qs = (x[rng.integers(0, len(x), 10)]
          + 0.05 * rng.normal(size=(10, 16))).astype(np.float32)
    snaps, reqs, metas, fronts = {}, [], {}, {}

    def snap():
        snaps[db.index.version] = (db.index.n_total, db.index.deleted.copy())

    def submit(i):
        while True:
            try:
                reqs.append(db.scheduler.submit(ns.Query(qs[i], k=K, eps=EPS,
                                                         ef=12)))
                return
            except ns.busy:
                db.scheduler.pump()

    def pump():
        db.scheduler.pump()
        for r in reqs:
            if r.result is not None and r.lane is not None \
                    and id(r) not in metas:
                metas[id(r)] = db.backend.last_meta[r.lane]
                fronts[id(r)] = db.backend.last_candidates[r.lane]

    snap()
    for i in range(5):
        submit(i)
    pump()
    assert db.scheduler.inflight or db.scheduler.pending
    db.upsert(qs[:3] + np.float32(0.01))
    snap()
    db.delete([17, 23])
    snap()
    for i in range(5, 8):
        submit(i)
    pump()
    db.upsert(rng.normal(size=(6, 16)).astype(np.float32))  # fills the delta
    snap()
    if background:
        db.index.wait_rebuild()
    assert db.index.swap_ready()
    for i in range(8, 10):
        submit(i)
    while any(r.result is None for r in reqs):
        pump()
    assert db.backend.swaps == 1 and db.index.epoch == 1
    out = []
    for r in reqs:
        meta = metas[id(r)]
        n_at, dele_at = snaps[max(v for v in snaps if v <= meta["version"])]
        ids = r.result.ids[r.result.ids >= 0]
        assert ids.size and (ids < n_at).all() and not dele_at[ids].any()
        if r.result.stats.certified:
            ok, sel = ns.recheck(db.index.float_view()[:n_at], "ip",
                                 fronts[id(r)][0], fronts[id(r)][1], EPS, K)
            assert ok and np.array_equal(np.asarray(sel), r.result.ids)
        out.append(dict(_res(r.result), epoch=meta["epoch"],
                        version=meta["version"]))
    assert {o["epoch"] for o in out} == {0, 1}
    st = db.stats()["index"]
    assert st["delta"] == 0 and st["epoch"] == 1
    return out


def engine_straddle(ns, start, p_start, target, p_to):
    """Four lanes admitted on ``p_start`` shards step once, the engine
    rescales to ``p_to`` and the lanes finish there. Each straddling lane
    must equal a fixed-mesh run of ``target`` at its final budget, or be
    certified and pass a Theorem-2 recheck of its frontier."""
    _, x = _world(2048)
    qs = np.random.default_rng(0).normal(size=(2048 + 8, 16)).astype(
        np.float32)[2048:]
    mesh_t = ns.make_mesh((p_to,), ("data",))
    eng = ns.ShardedEngine(start, x, ns.make_mesh((p_start,), ("data",)),
                           num_lanes=4, K0=16, max_k=8, resume="beam",
                           record_candidates=True)
    eng.prepare_rescale(p_to, mesh_t, index=target, prewarm=False)
    for lane in range(4):
        eng.admit(lane, ns.LaneRequest(q=qs[lane], k=K, eps=EPS,
                                       method="sharded"))
    eng.step()
    first = {lane: _res(r) for lane, r in eng.harvest()}
    straddled = [int(i) for i in np.flatnonzero(eng.status == ns.LANE_RUN)]
    assert eng.rescale(p_to) and eng.num_shards == p_to
    out = {}
    while eng.active_count():
        eng.step()
        out.update(eng.harvest())
    fixed = violations = 0
    for lane in straddled:
        r = out[lane]
        ids, sc, _ = ns.sds(target, x, qs[lane][None], K, EPS,
                            int(r.stats.K_final), mesh_t)
        if np.array_equal(_np(ids)[0], r.ids) \
                and np.array_equal(_np(sc)[0], r.scores):
            fixed += 1
            continue
        cand_ids, cand_sc = eng.last_candidates[lane]
        ok, sel = ns.recheck(x, "ip", cand_ids, cand_sc, EPS, K)
        if not (r.stats.certified and ok
                and np.array_equal(np.asarray(sel), r.ids)):
            violations += 1
    return dict(first=first, straddled=straddled, fixed=fixed,
                violations=violations,
                results={lane: _res(r) for lane, r in out.items()})


def _burst(sched, backend, burst, ns):
    """Submit a burst of 24 (at most 4 queued at a time), pump until served,
    then idle pumps until a shrink fires. Returns the requests, whether one
    was admitted into a lane after the grow, and the shard count after each
    pump."""
    reqs, i, admitted_on_new, trace = [], 0, False, []
    while i < len(burst) or sched.pending or sched.inflight:
        while i < len(burst) and len(sched.pending) < 4:
            reqs.append(sched.submit(burst[i], K, EPS))
            i += 1
        before = {lane: r.rid for lane, r in sched.inflight.items()}
        sched.pump()
        trace.append(int(backend.num_shards))
        if backend.num_shards == 4 and sched.scale_events and any(
                before.get(lane) != r.rid
                for lane, r in sched.inflight.items()):
            admitted_on_new = True
    for _ in range(24):
        sched.pump()
        trace.append(int(backend.num_shards))
        if any(e["to_shards"] < e["from_shards"] for e in sched.scale_events):
            break
    return reqs, admitted_on_new, trace


def _scale_log(sched):
    return [(e["from_shards"], e["to_shards"], e["pending"], e["inflight"])
            for e in sched.scale_events]


def elastic_scheduler(ns, index2, index4, burst):
    """``LaneScheduler(elastic=)`` over a bare 2-shard engine with the
    4-shard target (4 lanes) prepared: a burst must grow, admit on the new
    mesh, certify every request, then shrink when idle."""
    _, x = _world(2048)
    eng = ns.ShardedEngine(index2, x, ns.make_mesh((2,), ("data",)),
                           num_lanes=2, K0=16, max_k=8, resume="beam")
    eng.prepare_rescale(4, ns.make_mesh((4,), ("data",)), index=index4,
                        prewarm=False, num_lanes=4)
    sched = ns.LaneScheduler(backend=eng, elastic=ns.ElasticPolicy(**POLICY),
                             prewarm=False, max_pending=32)
    reqs, on_new, trace = _burst(sched, eng, burst, ns)
    return dict(results=[_res(r.result) for r in reqs],
                lanes=[r.lane for r in reqs], events=_scale_log(sched),
                admitted_on_new=on_new, trace=trace)


def elastic_facade(ns):
    """The elastic facade (``shards="auto"``, 2 of 4 shards, the 4-shard
    target prepared) under the burst, then idle pumps until a shrink.
    Returns its record and the facade."""
    _, x = _world(2048)
    db = ns.DiverseVectorDB(x, "ip", shards="auto",
                            elastic=ns.ElasticPolicy(**POLICY), num_lanes=2,
                            max_k=8, M=8, prewarm=False,
                            backend_kw=dict(K0=16, resume="beam"),
                            scheduler_kw=dict(max_pending=32))
    start = (db.backend.num_shards, db.backend.rescale_options())
    burst = np.random.default_rng(1).normal(size=(24, 16)).astype(np.float32)
    reqs, on_new, trace = _burst(db.scheduler, db.backend, burst, ns)
    st = db.stats()
    return dict(results=[_res(r.result) for r in reqs],
                lanes=[r.lane for r in reqs], events=_scale_log(db.scheduler),
                pumps=[e["pump"] for e in db.scheduler.scale_events],
                admitted_on_new=on_new, trace=trace, start=start,
                stats={k: st[k] for k in ("shards", "scale_events",
                                          "completed", "certified_frac")},
                lanes_after=(db.backend.num_lanes,
                             len(db.backend.last_meta))), db


def _reference_part(ns, part: str) -> dict:
    if part == "facade":
        return {f"facade_{q}": facade_reads(ns, q) for q in (None, "int8")}
    _, x = _world(2048)
    index2 = ns.build_sharded_index(x, 2, "ip", M=8)
    index4 = ns.reshard_index(index2, 4)
    if part == "straddle":
        return dict(mutable_straddle=mutable_straddle(ns),
                    index2=_host(index2), index4=_host(index4),
                    grow=engine_straddle(ns, index2, 2, index4, 4))
    burst = np.random.default_rng(1).normal(size=(24, 16)).astype(np.float32)
    return dict(shrink=engine_straddle(ns, index4, 4, index2, 2),
                scheduler=elastic_scheduler(ns, index2, index4, burst))


#: the reference's run in three parts, one subprocess each, run together
PARTS = ("facade", "straddle", "elastic")


def reference_run(path: str, part: str) -> None:
    """One part of the reference's side, run in a subprocess: the drivers'
    outputs and the indexes the port carries across, pickled to ``path``."""
    with open(path, "wb") as f:
        pickle.dump(_reference_part(_pkg("repro"), part), f)


# --------------------------------------------------- over the ranks ----

class Followed(Exception):
    """Raised on a rank other than 0 once rank 0 closed the facade or the
    engine it was following."""


def rank_pkg(world, device):
    """The drivers' names over the process group of ``world`` (a
    ``ProcessGroupMesh``): facades and engines serve one shard per rank;
    on rank 0 they are returned (engines under ``RankZeroBackend``), on the
    others the constructor follows rank 0 until it closes, then raises
    ``Followed``. Returns the namespace and the list of what rank 0 opened
    (closed by ``rank_run``); ``swaps`` collects each follower facade's
    epoch swaps."""
    from repro_torch import compat, db
    from repro_torch.serve.scheduler import RankZeroBackend, follow
    from repro_torch.sharded_search import engine, search

    ns = _pkg("repro_torch", device)
    opened, swaps = [], []

    def facade(*a, **kw):
        d = db.DiverseVectorDB(*a, mesh=world, device=device, **kw)
        if world.rank:
            swaps.append(d.backend.swaps)
            raise Followed
        opened.append(d)
        return d

    def sharded_engine(index, x, mesh, **kw):
        eng = engine.ShardedEngine(index, x, mesh, **kw)
        if world.rank:
            follow(eng)
            raise Followed
        eng = RankZeroBackend(eng)
        opened.append(eng)
        return eng

    def sds(index, x, qs, *a):
        """The fixed-mesh run a straddle is held to, in process."""
        mesh = compat.make_mesh((a[-1].size,), ("data",), device=device)
        return search.sharded_diverse_search(index, x, qs, *a[:-1], mesh)

    ns.DiverseVectorDB, ns.ShardedEngine, ns.sds = facade, sharded_engine, sds
    ns.make_mesh = lambda shape, axes: world.sub(shape[0])
    ns.swaps = swaps
    return ns, opened


#: what ``rank_run`` runs, by name: (driver, its arguments after ``ns``)
def _rank_parts(ns):
    _, x = _world(2048)
    index2 = ns.build_sharded_index(x, 2, "ip", M=8)
    index4 = ns.reshard_index(index2, 4)
    return dict(
        facade_None=(facade_reads, (None,)),
        facade_int8=(facade_reads, ("int8",)),
        facade_pq=(facade_reads, ("pq",)),
        mutable_straddle=(mutable_straddle, ()),
        grow=(engine_straddle, (index2, 2, index4, 4)),
        shrink=(engine_straddle, (index4, 4, index2, 2)),
        elastic_facade=(lambda ns: elastic_facade(ns)[0], ()),
        background=(mutable_straddle, (True,)),
        indexes=(lambda ns: dict(index2=_host(index2),
                                 index4=_host(index4)), ()))


def local_run(device) -> dict:
    """The ``LocalMesh`` runs of ``_rank_parts`` on ``device``, in process
    (what ``rank_run``'s rank 0 must equal)."""
    ns = _pkg("repro_torch", device)
    return {name: fn(ns, *args) for name, (fn, args) in
            _rank_parts(ns).items() if name in RANK_PARTS}


def rank_run(world, device) -> dict:
    """Every driver of ``_rank_parts`` over the group: rank 0's outputs, or
    on the other ranks the epoch swaps of each facade they followed."""
    ns, opened = rank_pkg(world, device)
    out = {}
    for name, (fn, args) in _rank_parts(ns).items():
        try:
            out[name] = fn(ns, *args)
        except Followed:
            out[name] = dict(swaps=list(ns.swaps))
        finally:
            while opened:
                opened.pop().close()
            ns.swaps.clear()
    return out


# ------------------------------------------------------------ tests ----

@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's run, in three subprocesses of four forced host
    devices, started together when the module's tests start so that they
    run beside the port-only tests; stopped when they end."""
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [SRC, HERE, os.environ.get("PYTHONPATH", "")]))
    procs = []
    for part in PARTS:
        path = str(tmp / f"{part}.pkl")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", "import sys, test_torch_sharded_db as t; "
             "t.reference_run(*sys.argv[1:])", path, part], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            path))
    yield procs
    for proc, _ in procs:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(reference):
    """The reference's outputs; a failing subprocess fails every test that
    uses them."""
    out = {}
    for proc, path in reference:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with open(path, "rb") as f:
            out.update(pickle.load(f))
    return out


@pytest.fixture(scope="module", autouse=True)
def rank_world(tmp_path_factory):
    """Four gloo ranks running ``rank_run``, started with the reference's
    subprocesses; killed when the module's tests end."""
    import torch_dist_ranks as R

    tmp = str(tmp_path_factory.mktemp("ranks"))
    ctx = R.start(R.sharded_db_rank, 4, tmp)
    yield ctx, tmp
    R.kill(ctx)


@pytest.fixture(scope="module")
def ranks(rank_world):
    """Each rank's ``rank_run`` output; a failing rank fails every test
    that uses them."""
    import torch_dist_ranks as R

    ctx, tmp = rank_world
    R.wait(ctx, timeout=600)
    out = []
    for r in range(4):
        with open(os.path.join(tmp, f"dbgloocpu_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def port():
    return _pkg("repro_torch")


class _Runs(dict):
    """The ``LocalMesh`` runs of the drivers, each made on first use."""

    def __init__(self, make):
        super().__init__()
        self.make = make

    def __missing__(self, name):
        self[name] = self.make[name]()
        return self[name]


@pytest.fixture(scope="module")
def local(port, ref):
    def straddle(direction):
        index2, index4 = _carry(ref["index2"]), _carry(ref["index4"])
        args = ((index2, 2, index4, 4) if direction == "grow"
                else (index4, 4, index2, 2))
        return engine_straddle(port, *args)

    return _Runs(dict(
        facade_None=lambda: facade_reads(port, None),
        facade_int8=lambda: facade_reads(port, "int8"),
        facade_pq=lambda: facade_reads(port, "pq"),
        mutable_straddle=lambda: mutable_straddle(port),
        grow=lambda: straddle("grow"), shrink=lambda: straddle("shrink"),
        elastic_facade=lambda: elastic_facade(port)))


def _carry(host):
    from repro_torch.sharded_search import index_from_host
    return index_from_host(host, device="cpu")


def _same(got: dict, want: dict, what: str, keys=("ids", "certified",
                                                  "K_final")):
    for key in keys:
        assert np.array_equal(got[key], want[key]), (what, key, got, want)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("quantized", [None, "int8"])
def test_sharded_facade_matches_reference(ref, local, quantized):
    got = local[f"facade_{quantized}"]
    want = ref[f"facade_{quantized}"]
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"read {i}")
    assert any(g["certified"] for g in got)


def test_mutable_straddle_matches_reference(ref, local):
    got, want = local["mutable_straddle"], ref["mutable_straddle"]
    assert len(got) == len(want) == 10
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"request {i}", keys=("ids", "certified", "K_final",
                                          "epoch", "version"))


@pytest.mark.parametrize("direction", ["grow", "shrink"])
def test_engine_straddle_matches_reference(ref, local, direction):
    got, want = local[direction], ref[direction]
    assert got["straddled"] == want["straddled"]
    assert len(got["straddled"]) >= 2
    assert got["violations"] == want["violations"] == 0
    assert got["fixed"] == want["fixed"]
    for part in ("first", "results"):
        assert sorted(got[part]) == sorted(want[part])
        for lane in want[part]:
            _same(got[part][lane], want[part][lane], f"{part} lane {lane}",
                  keys=("ids", "certified", "K_final", "expansions",
                        "rounds"))


def test_elastic_scheduler_matches_reference(ref, port):
    index2, index4 = _carry(ref["index2"]), _carry(ref["index4"])
    burst = np.random.default_rng(1).normal(size=(24, 16)).astype(np.float32)
    got, want = elastic_scheduler(port, index2, index4, burst), \
        ref["scheduler"]
    assert got["events"] == want["events"]
    assert any(t > f for f, t, _, _ in got["events"])
    assert any(t < f for f, t, _, _ in got["events"])
    assert got["admitted_on_new"] and want["admitted_on_new"]
    assert got["trace"] == want["trace"] and got["lanes"] == want["lanes"]
    for i, (g, w) in enumerate(zip(got["results"], want["results"])):
        _same(g, w, f"request {i}")
        assert g["certified"]


def test_elastic_facade_equals_bare_engine_scheduler(port, local):
    """The port's elastic facade, with no write, serves a burst exactly as
    a bare-engine ``LaneScheduler(elastic=)`` over the facade's own 2- and
    4-shard indexes: the same results, scale events and lanes."""
    from repro_torch.core.backend import RescalableBackend

    got, db = local["elastic_facade"]
    assert isinstance(db.backend, RescalableBackend)
    assert got["start"] == (2, (2, 4))
    # the burst ended on 2 shards: the 4-shard index is the target again
    assert db.engine.num_shards == 2
    index4 = db.engine._rescale_targets[4][1]
    burst = np.random.default_rng(1).normal(size=(24, 16)).astype(np.float32)
    bare = elastic_scheduler(port, db.index.sharded, index4, burst)
    assert got["admitted_on_new"] and got["trace"] == bare["trace"]
    assert got["events"] == bare["events"]
    assert got["lanes"] == bare["lanes"]
    for i, (g, b) in enumerate(zip(got["results"], bare["results"])):
        for key in ("ids", "scores", "certified", "K_final", "expansions"):
            assert np.array_equal(g[key], b[key]), (i, key)
    assert got["stats"] == dict(shards=2, scale_events=2, completed=24,
                                certified_frac=1.0)
    assert got["lanes_after"] == (2, 2)


def _bit_equal(got, want, path=""):
    """Equal leaf by leaf, float32 on its bits."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _bit_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _bit_equal(g, w, f"{path}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        if w.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        assert g.shape == w.shape and np.array_equal(g, w), (path, got, want)


#: the drivers run over the ranks, each held to its LocalMesh run; the
#: reference's parts cover all but the PQ reads and the elastic facade
#: (which its facade cannot serve under Python 3.12)
RANK_PARTS = ["facade_None", "facade_int8", "facade_pq", "mutable_straddle",
              "grow", "shrink", "elastic_facade"]
REFERENCE_PARTS = ["facade_None", "facade_int8", "mutable_straddle", "grow",
                   "shrink"]


@pytest.mark.parametrize("part", RANK_PARTS)
def test_facade_over_ranks_bit_equal_to_local_mesh(ranks, local, part):
    """Rank 0's outputs over four gloo ranks are the ``LocalMesh`` run's
    bit for bit; the followers followed every facade of the part."""
    want = local[part]
    if part == "elastic_facade":
        want = want[0]
    _bit_equal(ranks[0][part], want, part)
    if part not in ("grow", "shrink"):
        for r in range(1, 4):
            assert ranks[r][part] == dict(swaps=[int(
                part == "mutable_straddle")]), (r, ranks[r][part])


@pytest.mark.parametrize("part", REFERENCE_PARTS)
def test_facade_over_ranks_matches_reference(ranks, ref, part):
    """The ranks' results are the reference's: ids, certificates,
    ``K_final``, epochs and versions equal, scores within 1e-5 (the
    engine straddles run on the ranks' own indexes, which are the
    reference's bit for bit)."""
    for f in ("index2", "index4"):
        _bit_equal({k: ranks[0]["indexes"][f][k]
                    for k in ("vectors", "neighbors", "entries", "bases")},
                   {k: ref[f][k] for k in ("vectors", "neighbors",
                                           "entries", "bases")}, f)
    got, want = ranks[0][part], ref[part]
    if part in ("grow", "shrink"):
        assert got["straddled"] == want["straddled"]
        assert got["violations"] == want["violations"] == 0
        assert got["fixed"] == want["fixed"]
        for sub in ("first", "results"):
            assert sorted(got[sub]) == sorted(want[sub])
            for lane in want[sub]:
                _same(got[sub][lane], want[sub][lane], f"{sub} {lane}",
                      keys=("ids", "certified", "K_final", "expansions",
                            "rounds"))
        return
    keys = (("ids", "certified", "K_final", "epoch", "version")
            if part == "mutable_straddle" else ("ids", "certified",
                                                "K_final"))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"{part} {i}", keys=keys)


def test_elastic_facade_over_ranks_scales(ranks):
    """Over the ranks the elastic facade starts on 2 of 4 ranks, grows,
    admits on the new mesh, certifies every request and shrinks back."""
    got = ranks[0]["elastic_facade"]
    assert got["start"] == (2, (2, 4))
    assert any(t > f for f, t, _, _ in got["events"])
    assert any(t < f for f, t, _, _ in got["events"])
    assert got["admitted_on_new"] and len(got["pumps"]) == 2
    assert all(r["certified"] for r in got["results"])


def test_background_rebuild_over_ranks(ranks):
    """A background rebuild over the ranks: the driver's validity gates
    held on rank 0 (each result valid at its tag, no deleted id served,
    every certified frontier re-proved, epochs 0 and 1, one swap there),
    and exactly one swap on every other rank."""
    got = ranks[0]["background"]
    assert len(got) == 10
    assert {g["epoch"] for g in got} == {0, 1}
    for r in range(1, 4):
        assert ranks[r]["background"] == dict(swaps=[1]), r


def test_rescale_while_rebuild_pending_reshards_the_epoch(port):
    """A rescale that lands after the rebuild was built for the old shard
    count: the swap reshards the rebuilt epoch onto the serving count, and
    every later result is valid at its tag."""
    _, x = _world(512)
    db = port.DiverseVectorDB(x, "ip", shards="auto", elastic=True,
                              num_lanes=2, max_k=8, M=8, delta_capacity=8,
                              background_rebuild=False, prewarm=False,
                              backend_kw=dict(K0=16))
    assert db.index.shards == 2
    r0 = db.search(x[7], k=K, eps=EPS)
    new = db.upsert(x[:8] + np.float32(0.01))     # fills the delta
    assert db.index.swap_ready()
    dead = int(r0.ids[0])
    db.delete([dead])
    assert db.backend.rescale(4)
    assert db.index.shards == 4 and db.backend.num_lanes == 4
    assert len(db.backend.last_candidates) == 4
    r1 = db.search(x[7], k=K, eps=EPS)
    assert db.backend.swaps == 1 and db.backend.reshards == 1
    assert db.index.epoch == 1 and db.index.sharded.num_shards == 4
    assert db.engine.index is db.index.sharded
    assert dead not in r1.ids
    assert db.index.delta_count == 0 and db.index.n_total == 520
    # the rebuilt epoch holds the upserted rows: each is found as its own
    # nearest neighbour through the new shard graphs
    r2 = db.search(x[0] + np.float32(0.01), k=K, eps=EPS)
    assert int(new[0]) in db.backend.last_candidates[0][0].tolist()
    assert r2.stats.certified


def test_background_rebuild_failure_surfaces(port):
    """A sharded build that raises on the rebuild thread is raised again
    on the serving side, not lost with the thread."""
    from repro_torch.index.mutable import MutableIndex

    _, x = _world(256)
    idx = MutableIndex(x, "ip", M=8, shards=2, device="cpu")

    def broken(snap):
        raise MemoryError("shard build ran out")

    idx._build = broken
    assert idx.request_rebuild(background=True)
    idx._thread.join(timeout=60)
    assert not idx._thread.is_alive()
    with pytest.raises(RuntimeError, match="rebuild failed") as info:
        idx.wait_rebuild()
    assert isinstance(info.value.__cause__, MemoryError)
    assert not idx.swap_ready()          # raised once, then cleared


def test_swap_index_refuses_occupied_lanes_and_drops_targets(port):
    _, x = _world(256)
    from repro_torch.sharded_search.search import build_sharded_index

    idx2 = build_sharded_index(x, 2, "ip", M=8, device="cpu")
    eng = port.ShardedEngine(idx2, x, port.make_mesh((2,), ("data",)),
                             num_lanes=2, K0=16, max_k=8)
    eng.prepare_rescale(4, port.make_mesh((4,), ("data",)), prewarm=False)
    assert eng.rescale_options() == (2, 4)
    eng.admit(0, port.LaneRequest(q=x[0], k=K, eps=EPS, method="sharded"))
    with pytest.raises(RuntimeError, match="occupied"):
        eng.swap_index(idx2, x)
    while eng.active_count():
        eng.step()
    with pytest.raises(ValueError, match="shard count"):
        eng.swap_index(build_sharded_index(x, 4, "ip", M=8, device="cpu"), x)
    eng.swap_index(idx2, x)
    assert eng.rescale_options() == (2,)
    assert eng.signature_log.counts[("swap", 2, 256)] == 1
    with pytest.raises(RuntimeError, match="prepare_rescale"):
        eng.rescale(4)
