"""The sharded search over a process group, one shard per rank, against the
reference and against the one-process ``LocalMesh`` path.

The world is ``tests/dist_scripts/sharded_search_check.py``'s: N = 2048,
d = 16, ``ip``, M = 8, 8 queries, 4 shards, the index built by the
reference's builder. The reference runs in one subprocess with four forced
host devices: ``sharded_topk`` (tournament and all-gather), two rounds of
``sharded_topk_resume``, ``sharded_diverse_search`` and its
``ShardedEngine`` serving the 8 queries in lockstep, each lane's result
with its counters (what ``sharded_progressive_diverse`` wraps). Four
spawned gloo ranks (``tests/torch_dist_ranks``) each load their shard of
that index (``local_shard``) and run the same calls, plus
``sharded_progressive_diverse`` and a ``LaneScheduler`` over a 3-lane
``ShardedEngine`` serving the 8 queries (admission into freed lanes
mid-run; the scheduler on rank 0, ``follow`` on the others); so does a
``LocalMesh`` of four in process. Every lane is lane-separable, so the
progressive lockstep and the scheduler give each query the reference
engine's result. Ids, certificates, ``K_final`` and
expansions must be the reference's, scores within 1e-5, and every rank's
result the ``LocalMesh``'s bit for bit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro import sharded_search as J
from repro_torch import sharded_search as T
from repro_torch.compat import make_mesh

torch.set_num_threads(1)

ATOL = 1e-5
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TESTS = os.path.dirname(os.path.abspath(__file__))

REF_SCRIPT = r"""
import os, sys
import numpy as np, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core.backend import LaneRequest
from repro.sharded_search import (ShardedEngine, ShardedIndex,
    beam_state_capacity, init_sharded_state, sharded_diverse_search,
    sharded_topk, sharded_topk_resume)

tmp = sys.argv[1]
with np.load(os.path.join(tmp, "world.npz")) as f:
    X, qs = f["X"], f["qs"]
with np.load(os.path.join(tmp, "index.npz")) as f:
    idx = ShardedIndex(**{k: jnp.asarray(f[k]) for k in
                          ("vectors", "neighbors", "entries", "bases")},
                       metric="ip")
mesh = make_mesh((4,), ("data",))
out = {}
for merge in ("tournament", "allgather"):
    r = sharded_topk(idx, jnp.asarray(qs), k=10, L=64, mesh=mesh,
                     merge=merge, with_expansions=True)
    for name, a in zip(("ids", "scores", "expansions"), r):
        out[f"topk_{merge}_{name}"] = np.asarray(a)
cap = beam_state_capacity(idx, 64)
state = init_sharded_state(idx, 8, cap, mesh)
lanes = np.arange(8)
ids, sc, state = sharded_topk_resume(idx, state, jnp.asarray(qs), lanes,
                                     np.ones(8, bool), 16, 64, mesh)
out.update(resume1_ids=np.asarray(ids), resume1_scores=np.asarray(sc))
half = lanes[::2]
ids, sc, state = sharded_topk_resume(idx, state, jnp.asarray(qs[half]), half,
                                     np.zeros(len(half), bool), 32, 128, mesh)
out.update(resume2_ids=np.asarray(ids), resume2_scores=np.asarray(sc),
           resume2_steps=np.asarray(state.steps).sum(0))
r = sharded_diverse_search(idx, jnp.asarray(X), jnp.asarray(qs), k=5, eps=4.0,
                           K=64, mesh=mesh, with_expansions=True)
for name, a in zip(("ids", "scores", "certified", "expansions"), r):
    out["diverse_" + name] = np.asarray(a)
# the engine in lockstep over the 8 queries (what sharded_progressive_diverse
# wraps), with each lane's real counters
eng = ShardedEngine(idx, jnp.asarray(X), mesh, num_lanes=8, K0=16, max_k=8,
                    resume="beam")
for lane in range(8):
    eng.admit(lane, LaneRequest(q=qs[lane], k=5, eps=4.0, method="sharded"))
res = [None] * 8
while eng.active_count():
    eng.step()
    for lane, x in eng.harvest():
        res[lane] = x
        eng.recycle(lane)
out.update(eng_ids=np.stack([x.ids for x in res]),
           eng_scores=np.stack([x.scores for x in res]),
           eng_certified=np.array([x.stats.certified for x in res]),
           eng_K_final=np.array([x.stats.K_final for x in res]),
           eng_expansions=np.array([x.stats.expansions for x in res]))
np.savez(os.path.join(tmp, "ref.npz"), **out)
"""


def _exact(n):
    return "close" if n == "scores" else "exact"


#: (the port's key, the reference's key, how they compare). A lane is
#: lane-separable, so the progressive lockstep and the 3-lane scheduler
#: give each query the reference engine's lockstep result
KEYS = (
    [(f"topk_{m}_{n}", f"topk_{m}_{n}", _exact(n))
     for m in ("tournament", "allgather")
     for n in ("ids", "scores", "expansions")]
    + [(k, k, _exact(k.split("_")[1])) for k in (
        "resume1_ids", "resume1_scores", "resume2_ids", "resume2_scores",
        "resume2_steps")]
    + [(f"diverse_{n}", f"diverse_{n}", _exact(n))
       for n in ("ids", "scores", "certified", "expansions")]
    + [(f"progressive_beam_{n}", f"eng_{n}", _exact(n))
       for n in ("ids", "scores", "certified", "K_final")]
    + [(f"sched_{n}", f"eng_{n}", _exact(n))
       for n in ("ids", "scores", "certified", "K_final", "expansions")])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The index built by the reference's builder in process; then the
    reference's run (a subprocess), the ranks and the ``LocalMesh`` at
    once."""
    tmp = str(tmp_path_factory.mktemp("search4"))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2048, 16)).astype(np.float32)
    qs = rng.normal(size=(8, 16)).astype(np.float32)
    jidx = J.build_sharded_index(X, 4, "ip", M=8)
    np.savez(os.path.join(tmp, "world.npz"), X=X, qs=qs)
    np.savez(os.path.join(tmp, "index.npz"), meta_metric=np.asarray("ip"),
             meta_scale_rows=np.asarray(8),
             **{f: np.asarray(getattr(jidx, f)) for f in
                ("vectors", "neighbors", "entries", "bases")})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [SRC, TESTS, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, tmp], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        R.spawn(R.search_rank, 4, tmp)
        index = T.index_from_host(
            R.load_host_index(os.path.join(tmp, "index.npz")), device="cpu")
        local = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v)) for k, v in R.search_ops(
            index, torch.from_numpy(X), torch.from_numpy(qs),
            make_mesh((4,), ("data",), device="cpu")).items()}
        _, err = proc.communicate(timeout=400)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    ranks = [R.load(tmp, "searchgloocpu", r) for r in range(4)]
    ref = dict(np.load(os.path.join(tmp, "ref.npz")))
    return ref, ranks, local


def _same(got, want, how, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if how == "close":
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=ATOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _group(prefix):
    return [kh for kh in KEYS if kh[0].startswith(prefix)]


PREFIXES = ["topk_", "resume", "diverse_", "progressive_beam", "sched_"]


@pytest.mark.parametrize("prefix", PREFIXES)
def test_process_group_matches_reference(world, prefix):
    ref, ranks, _ = world
    for r, got in enumerate(ranks):
        if prefix == "sched_" and r:
            continue                      # results are rank 0's
        for key, rkey, how in _group(prefix):
            _same(got[key], ref[rkey], how, f"rank {r} {key}")


@pytest.mark.parametrize("prefix", PREFIXES)
def test_process_group_bit_equal_to_local_mesh(world, prefix):
    ref, ranks, local = world
    for r, got in enumerate(ranks):
        if prefix == "sched_" and r:
            continue
        for key, _, _ in _group(prefix):
            _same(got[key], local[key], "exact", f"rank {r} {key}")
    for key, rkey, how in _group(prefix):
        _same(local[key], ref[rkey], how, f"LocalMesh {key}")


def test_scheduler_admits_mid_run(world):
    """Rank 0 refilled a freed lane while others were in flight and served
    all 8; nothing was staged through host memory (CPU tensors)."""
    _, ranks, _ = world
    assert bool(ranks[0]["sched_mid_run"])
    assert int(ranks[0]["sched_latency_n"]) == 8
    for got in ranks:
        assert int(got["staged"]) == 0


def test_rank_index_refuses_the_wrong_mesh(world):
    """A rank's shard on a LocalMesh of four (or a whole index on a process
    group) is refused by the mesh check; resharded, a rank's shard becomes
    its part of the target, built from the host rows: the whole index's
    reshard, then ``local_shard`` (no part for a rank outside the target's
    two ranks)."""
    ref, _, _ = world
    del ref
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    whole = T.build_sharded_index(x, 4, "ip", M=4, device="cpu")
    one = T.index_from_host(T.local_shard(T.index_to_host(whole), 2),
                            device="cpu")
    assert (one.num_shards, one.local_shards, int(one.bases[0])) == (4, 1, 32)
    with pytest.raises(ValueError, match="1 here"):
        T.sharded_topk(one, x[:2], 4, 8, make_mesh((4,), ("data",),
                                                   device="cpu"))
    want = T.index_to_host(T.reshard_index(whole, 2, x))
    for shard in (0, 1, -1):
        got = T.index_to_host(T.reshard_index(one, 2, x, shard=shard))
        part = T.local_shard(want, shard)
        assert got["total_shards"] == part["total_shards"] == 2
        for f in ("vectors", "neighbors", "entries", "bases"):
            np.testing.assert_array_equal(got[f], part[f], err_msg=f)
