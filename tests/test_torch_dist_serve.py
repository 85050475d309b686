"""The facade's building blocks over a process group, and the serve
launcher under ``torchrun``'s variables, on the CPU.

* In process: ``build_sharded_index(shard=)`` and ``reshard_index(shard=)``
  of a rank's part (float, int8, PQ) equal ``local_shard`` of the whole
  index's build or reshard bit for bit, a rank outside the mesh holding no
  shard; ``compat.device_count()`` is a default group's world size inside
  one (a group of one here) and 4 outside, and ``shards="auto"`` follows it.
* Four gloo ranks (``tests/torch_dist_ranks.serve_rank``, spawned once):
  ``launch.serve.main`` with ``--backend gloo`` and ``--mesh-shards 4``,
  then ``--elastic``; rank 0's retrieved ids, certificates and generated
  tokens must equal the one-process run of the same flags. Then
  ``device_count()`` inside the ranks' group is 4 and a ``shards="auto"``
  facade serves one shard a rank, its result the one-process facade's.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro_torch import compat
from repro_torch.sharded_search import search as T

torch.set_num_threads(1)

FIELDS = ("vectors", "neighbors", "entries", "bases", "codes", "scales",
          "codebooks")


def _x(n=512, d=16):
    return np.random.default_rng(3).normal(size=(n, d)).astype(np.float32)


def _equal(got: dict, want: dict, what: str) -> None:
    for f in FIELDS:
        g, w = got.get(f), want.get(f)
        assert (g is None) == (w is None), (what, f)
        if w is not None:
            assert g.shape == w.shape, (what, f, g.shape, w.shape)
            np.testing.assert_array_equal(
                g.view(np.uint32) if g.dtype == np.float32 else g,
                w.view(np.uint32) if w.dtype == np.float32 else w,
                err_msg=f"{what} {f}")
    assert got.get("total_shards") == want.get("total_shards"), what


def _build(x, p, quantized, **kw):
    return T.build_sharded_index(x, p, "ip", M=8, quantized=quantized,
                                 pq_m=4, pq_codes=16, device="cpu", **kw)


@pytest.mark.parametrize("quantized", [None, "int8", "pq"])
def test_rank_build_is_local_shard_of_whole(quantized):
    x = _x()
    whole = T.index_to_host(_build(x, 4, quantized))
    for s in (0, 3, -1):
        part = T.index_to_host(_build(x, 4, quantized, shard=s))
        _equal(part, T.local_shard(whole, s), f"{quantized} shard {s}")


@pytest.mark.parametrize("quantized", [None, "int8", "pq"])
@pytest.mark.parametrize("p_old,p_new", [(2, 4), (4, 2)])
def test_rank_reshard_is_local_shard_of_whole_reshard(quantized, p_old,
                                                      p_new):
    """From the host rows alone: a rank's part of the old index, or none
    (a rank outside the old mesh), becomes its part of the target."""
    x = _x()
    old = _build(x, p_old, quantized)
    want = T.index_to_host(T.reshard_index(old, p_new, x))
    host = T.index_to_host(old)
    for r_old in (0, -1):
        part = T.index_from_host(T.local_shard(host, r_old), device="cpu")
        for s in (0, p_new - 1, -1):
            got = T.index_to_host(T.reshard_index(part, p_new, x, shard=s))
            _equal(got, T.local_shard(want, s),
                   f"{quantized} {p_old}->{p_new} from {r_old} to {s}")


def test_device_count_follows_the_default_group(tmp_path):
    """4 outside a group, the world size inside one (one rank here), and
    ``shards="auto"`` then serves over the group's mesh."""
    import torch.distributed as dist

    from repro_torch.db import DiverseVectorDB

    assert not compat.in_process_group() and compat.device_count() == 4
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        assert compat.device_count() == 1
        x = _x()
        db = DiverseVectorDB(x, "ip", shards="auto", num_lanes=2, max_k=8,
                             M=8, prewarm=False, device="cpu")
        assert db.world.size == 1 and db.backend.num_shards == 1
        one = DiverseVectorDB(x, "ip", shards=1, num_lanes=2, max_k=8, M=8,
                              prewarm=False, device="cpu")
        a, b = db.search(x[3], k=5, eps=4.0), one.search(x[3], k=5, eps=4.0)
        assert np.array_equal(a.ids, b.ids)
        assert np.array_equal(a.scores.view(np.uint32),
                              b.scores.view(np.uint32))
        with pytest.raises(ValueError, match=">= 2 devices"):
            DiverseVectorDB(x, "ip", shards="auto", elastic=True, M=8,
                            prewarm=False, device="cpu")
    finally:
        dist.destroy_process_group()
    assert compat.device_count() == 4


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The four ranks' outputs, and the one-process runs of each mode."""
    from repro_torch.launch import serve as launcher

    tmp = str(tmp_path_factory.mktemp("serve"))
    ctx = R.start(R.serve_rank, 4, tmp)
    try:
        one = {}
        for mode, flags in R.SERVE_MODES.items():
            rec: dict = {}
            real = R.recorded_pipeline(launcher, rec)
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    assert launcher.main(R.SERVE_ARGS + flags) == 0
            finally:
                launcher.RagPipeline = real
            one[mode] = rec
        R.wait(ctx, timeout=400)
    finally:
        R.kill(ctx)
    return [R.load(tmp, "serve", r) for r in range(4)], one


@pytest.mark.parametrize("mode", list(R.SERVE_MODES))
def test_launcher_under_torchrun_equals_one_process(served, mode):
    ranks, one = served
    for r in range(4):
        assert int(ranks[r][f"{mode}_rc"]) == 0, r
    got = ranks[0]
    for k in ("ids", "certified", "tokens"):
        np.testing.assert_array_equal(got[f"{mode}_{k}"],
                                      np.asarray(one[mode][k]),
                                      err_msg=f"{mode} {k}")
    assert got[f"{mode}_certified"].any()


def test_auto_shards_follow_the_ranks(served):
    ranks, _ = served
    from repro_torch.db import DiverseVectorDB

    for r in range(4):
        assert int(ranks[r]["outside"]) == 4 and int(ranks[r]["inside"]) == 4
    got = ranks[0]
    assert int(got["auto_shards"]) == int(got["auto_world"]) == 4
    x = np.random.default_rng(0).normal(size=(512, 16)).astype(np.float32)
    db = DiverseVectorDB(x, "ip", shards=4, num_lanes=2, max_k=8, M=8,
                         prewarm=False, device="cpu")
    want = db.search(x[3], k=5, eps=4.0)
    np.testing.assert_array_equal(got["auto_ids"], want.ids)
    np.testing.assert_array_equal(got["auto_scores"].view(np.uint32),
                                  want.scores.view(np.uint32))
