"""repro_torch.sharded_search against repro.sharded_search on the CPU.

Both packages search the same shard graphs: the reference builds the
``ShardedIndex`` and ``index_from_host`` carries its leaves across. Per
lane, ids, certificates, K_final, expansions, growths / rounds and the last
candidate frontier must be equal; scores within 1e-5 (bit-equal is
expected at these widths, since every score reduces in ``dot_seq``'s
order).

* P = 1, in process: the 256 x 12 ``ip`` world of
  ``tests/test_sharded_resume.py`` on a one-device mesh (the engine and the
  int8 / PQ indexes are in ``test_torch_sharded_engine.py``).
* P = 4: the reference runs in one subprocess with four forced host
  devices (as ``tests/dist_scripts/*`` do) on ``sharded_search_check.py``'s
  shape, N = 2048, d = 16, ``ip``, M = 8, 8 queries, and saves its index
  and results; the port runs the same calls on the carried index.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sharded_search as J
from repro.compat import make_mesh as jmake_mesh
from repro_torch import sharded_search as T
from repro_torch.compat import make_mesh as tmake_mesh

torch.set_num_threads(1)

ATOL = 1e-5
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
LEAVES = ("vectors", "neighbors", "entries", "bases", "codes", "scales",
          "codebooks")


def _host(jidx) -> dict:
    host = {f: (None if getattr(jidx, f) is None
                else np.asarray(getattr(jidx, f))) for f in LEAVES}
    return dict(host, metric=jidx.metric, scheme=jidx.scheme,
                scale_rows=jidx.scale_rows)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(got, ref, what=""):
    """Integer/bool outputs equal, float outputs within ATOL."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if ref.dtype.kind == "f":
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        ok = np.isfinite(ref)
        np.testing.assert_allclose(got[ok], ref[ok], rtol=0, atol=ATOL,
                                   err_msg=what)
        np.testing.assert_array_equal(got[~ok], ref[~ok], err_msg=what)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=what)


class World:
    """One index in both packages, its meshes, corpus and queries."""

    def __init__(self, x, jidx, qs):
        p = int(jidx.num_shards)
        self.x, self.qs, self.jidx = x, qs, jidx
        self.tidx = T.index_from_host(_host(jidx), device="cpu")
        self.jmesh = jmake_mesh((p,), ("data",))
        self.tmesh = tmake_mesh((p,), ("data",), device="cpu")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 12)).astype(np.float32)
    jidx = J.build_sharded_index(x, 1, "ip", M=8)
    qs = rng.normal(size=(6, 12)).astype(np.float32)
    return World(x, jidx, qs)


EPSS = np.array([4.0, 3.0, 5.0, 4.0, 2.5, 6.0], np.float32)


# ------------------------------------------------------------- P = 1 ----

def test_index_carrier_round_trip(world):
    host = T.index_to_host(world.tidx)
    for f in LEAVES:
        ref = getattr(world.jidx, f)
        assert (host[f] is None) == (ref is None), f
        if ref is not None:
            np.testing.assert_array_equal(host[f], np.asarray(ref))
    assert world.tidx.dim == 12 and world.tidx.num_shards == 1
    assert (world.tidx.corpus_bytes_per_vector()
            == world.jidx.corpus_bytes_per_vector())


def test_sharded_topk_p1(world):
    ref = J.sharded_topk(world.jidx, jnp.asarray(world.qs), 10, 40,
                         world.jmesh, with_expansions=True)
    got = T.sharded_topk(world.tidx, world.qs, 10, 40, world.tmesh,
                         with_expansions=True)
    for g, r, what in zip(got, ref, ("ids", "scores", "expansions")):
        _same(g, r, what)


@pytest.mark.parametrize("eps,method", [("scalar", "div_astar"),
                                        ("per_query", "div_astar"),
                                        ("per_query", "greedy")])
def test_sharded_diverse_search_p1(world, eps, method):
    e = 4.0 if eps == "scalar" else EPSS
    ref = J.sharded_diverse_search(world.jidx, jnp.asarray(world.x),
                                   jnp.asarray(world.qs), 4, e, 32,
                                   world.jmesh, method=method,
                                   with_expansions=True)
    got = T.sharded_diverse_search(world.tidx, world.x, world.qs, 4, e, 32,
                                   world.tmesh, method=method,
                                   with_expansions=True)
    for g, r, what in zip(got, ref, ("ids", "scores", "certified",
                                     "expansions")):
        _same(g, r, what)


def _state_host(js) -> dict:
    return {f: np.asarray(getattr(js, f)) for f in js._fields}


def test_sharded_diverse_resume_p1(world):
    """A fresh round at K = 16 for every lane, then a resumed round at
    K = 32 for three of them (one padded twice): outputs and every leaf of
    the carried state equal, starting from the reference's own state."""
    cap = J.beam_state_capacity(world.jidx, 256)
    js = J.init_sharded_state(world.jidx, 6, cap)
    ts = T.state_from_host(_state_host(js), device="cpu")
    assert ts.capacity == cap == T.beam_state_capacity(world.tidx, 256)
    rounds = [(np.arange(6), np.ones(6, bool), 16),
              (np.array([1, 3, 4, 1]), np.zeros(4, bool), 32)]
    for lanes, fresh, K in rounds:
        qs = world.qs[lanes]
        ref = J.sharded_diverse_resume(
            world.jidx, jnp.asarray(world.x), js, jnp.asarray(qs), lanes,
            fresh, 4, EPSS[lanes], K, world.jmesh)
        got = T.sharded_diverse_resume(world.tidx, world.x, ts, qs, lanes,
                                       fresh, 4, EPSS[lanes], K, world.tmesh)
        for g, r, what in zip(got[:5], ref[:5], ("ids", "scores", "cand_ids",
                                                 "cand_scores", "certified")):
            _same(g, r, f"K={K} {what}")
        js, ts = ref[5], got[5]
        for f in js._fields:
            _same(getattr(ts, f), getattr(js, f), f"K={K} state.{f}")


@pytest.mark.parametrize("resume", ["beam", "scratch"])
def test_sharded_progressive_diverse_p1(world, resume):
    ref = J.sharded_progressive_diverse(
        world.jidx, jnp.asarray(world.x), jnp.asarray(world.qs), 4, EPSS,
        world.jmesh, K0=16, resume=resume)
    got = T.sharded_progressive_diverse(world.tidx, world.x, world.qs, 4,
                                        EPSS, world.tmesh, K0=16,
                                        resume=resume)
    for g, r, what in zip(got, ref, ("ids", "scores", "certified",
                                     "K_final")):
        _same(g, r, what)


def test_sharded_index_builder_and_guards(world):
    """The port's own builder gives the reference's shape, and the paths
    it does not port yet say so."""
    tidx = T.build_sharded_index(world.x, 2, "ip", M=8, quantized="int8",
                                 device="cpu")
    jidx = J.build_sharded_index(world.x, 2, "ip", M=8, quantized="int8")
    for f in ("neighbors", "codes", "scales", "bases"):
        assert tuple(getattr(tidx, f).shape) == getattr(jidx, f).shape, f
    _same(tidx.codes, jidx.codes, "int8 codes")
    _same(tidx.bases, jidx.bases, "bases")
    with pytest.raises(NotImplementedError, match="later slice"):
        T.build_sharded_index(world.x, 1, "ip", builder="hnsw", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        T.sharded_topk(world.tidx, world.qs, 4, 16,
                       tmake_mesh((2,), ("data",), device="cpu"))
    with pytest.raises(ValueError, match="below the resumable-beam floor"):
        T.ShardedEngine(world.tidx, world.x, world.tmesh, state_capacity=8)


def test_int8_stacked_view_pads_scale_blocks(world):
    """Shards of 250 rows with 8-row scale blocks: the stacked corpus the
    lockstep loop reads gives every shard row its own shard's code and
    scale, and the ragged last block of a shard is not shared with the
    next shard."""
    from repro_torch import quant
    from repro_torch.sharded_search.search import _corpus_parts

    x = np.concatenate([world.x, world.x[:244]])           # 500 rows
    idx = T.build_sharded_index(x, 2, "ip", M=8, quantized="int8",
                                device="cpu")
    corpus, stride = _corpus_parts(idx)
    assert stride == 256 and corpus.codes.shape == (512, 12)
    rows = corpus.row_scales()
    for s in range(2):
        own = quant.quantize_int8(x[s * 250:(s + 1) * 250], device="cpu")
        _same(corpus.codes[s * 256:s * 256 + 250], own.codes, f"codes {s}")
        _same(rows[s * 256:s * 256 + 250], own.row_scales(), f"scales {s}")


# ------------------------------------------------------------- P = 4 ----

P4_SCRIPT = r"""
import sys
import numpy as np
import jax.numpy as jnp
from repro.compat import make_mesh
from repro.sharded_search import (build_sharded_index, sharded_topk,
                                  sharded_diverse_search,
                                  sharded_progressive_diverse)

rng = np.random.default_rng(0)
N, d = 2048, 16
X = rng.normal(size=(N, d)).astype(np.float32)
idx = build_sharded_index(X, 4, "ip", M=8)
mesh = make_mesh((4,), ("data",))
qs = rng.normal(size=(8, d)).astype(np.float32)
out = dict(X=X, qs=qs)
for f in ("vectors", "neighbors", "entries", "bases"):
    out["index_" + f] = np.asarray(getattr(idx, f))
for merge in ("tournament", "allgather"):
    r = sharded_topk(idx, jnp.asarray(qs), k=10, L=64, mesh=mesh,
                     merge=merge, with_expansions=True)
    for name, a in zip(("ids", "scores", "expansions"), r):
        out[f"topk_{merge}_{name}"] = np.asarray(a)
r = sharded_diverse_search(idx, jnp.asarray(X), jnp.asarray(qs), k=5, eps=4.0,
                           K=64, mesh=mesh, with_expansions=True)
for name, a in zip(("ids", "scores", "certified", "expansions"), r):
    out["diverse_" + name] = np.asarray(a)
for resume in ("beam", "scratch"):
    r = sharded_progressive_diverse(idx, jnp.asarray(X), jnp.asarray(qs),
                                    k=5, eps=4.0, mesh=mesh, K0=16,
                                    resume=resume)
    for name, a in zip(("ids", "scores", "certified", "K_final"), r):
        out[f"progressive_{resume}_{name}"] = np.asarray(a)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def p4_reference(tmp_path_factory):
    """The reference's P = 4 run, in one subprocess with four forced host
    devices, started when the module's tests start so that it runs beside
    the P = 1 tests; stopped when they end."""
    path = str(tmp_path_factory.mktemp("p4") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", P4_SCRIPT, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, path
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def p4(p4_reference):
    """The reference's P = 4 results and the carried index; a failing
    subprocess fails the tests that use it."""
    proc, path = p4_reference
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    ref = dict(np.load(path))
    host = {f: ref["index_" + f] for f in ("vectors", "neighbors", "entries",
                                            "bases")}
    host.update(metric="ip", scheme=None, scale_rows=8)
    return (ref, T.index_from_host(host, device="cpu"),
            tmake_mesh((4,), ("data",), device="cpu"))


@pytest.mark.parametrize("merge", ["tournament", "allgather"])
def test_sharded_topk_p4(p4, merge):
    ref, idx, mesh = p4
    got = T.sharded_topk(idx, ref["qs"], 10, 64, mesh, merge=merge,
                         with_expansions=True)
    for g, name in zip(got, ("ids", "scores", "expansions")):
        _same(g, ref[f"topk_{merge}_{name}"], f"{merge} {name}")
    _same(got[0], ref["topk_tournament_ids"], "tournament == allgather")


def test_sharded_diverse_search_p4(p4):
    ref, idx, mesh = p4
    got = T.sharded_diverse_search(idx, ref["X"], ref["qs"], 5, 4.0, 64, mesh,
                                   with_expansions=True)
    for g, name in zip(got, ("ids", "scores", "certified", "expansions")):
        _same(g, ref["diverse_" + name], name)


@pytest.mark.parametrize("resume", ["beam", "scratch"])
def test_sharded_progressive_diverse_p4(p4, resume):
    ref, idx, mesh = p4
    got = T.sharded_progressive_diverse(idx, ref["X"], ref["qs"], 5, 4.0,
                                        mesh, K0=16, resume=resume)
    for g, name in zip(got, ("ids", "scores", "certified", "K_final")):
        _same(g, ref[f"progressive_{resume}_{name}"], f"{resume} {name}")
