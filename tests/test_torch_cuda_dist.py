"""The process-group mesh on the card: JAX-free, skipped without CUDA.

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_dist.py -q

* gloo ranks sharing card 0: every collective of the mesh (its ``psum``,
  ``pmax``, ``all_gather`` and the partner ``exchange``), two rounds of
  ``compressed_psum``, and ``sharded_topk`` (both merges, its beams on the
  ``sim_gather`` kernel and each butterfly round on the two-run
  ``topk_merge`` kernel) must equal the same ranks on the CPU bit for
  bit, both matmuls within 1e-5 (cuBLAS sums in its own order); the
  exchanges stage the card's tensors through host memory
  (``staged_bytes`` > 0: gloo's point-to-point ops do not take them).
* NCCL at world size 1: the same collectives equal gloo's on the CPU.
* With two cards or more: NCCL with one card per rank, the same checks.
* Tensor parallelism: the reduced qwen2 (vocabulary 504) on a (1, 2) mesh
  of gloo ranks sharing the card, its prefill and 4 decode steps' logits
  within 4 bf16 ulps of one process's on the card, and one train step's
  loss at rtol 1e-4; the same for the reduced mamba2 (Mamba-2's heads over
  the model axis, w_in and the conv cut part by part).
"""
import os

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro_torch import sharded_search as T

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from repro_torch.kernels import _build
    _build.build_all()          # the ranks load the kernels, never build
    return torch.device("cuda")


def _run(fn, world, tmp, tag, backend, device, **kw):
    path = os.path.join(tmp, f"{tag}_{fn.__name__}_{backend}_{device}")
    os.makedirs(path, exist_ok=True)
    for name in ("index.npz", "world.npz"):
        if os.path.exists(os.path.join(tmp, name)):
            os.link(os.path.join(tmp, name), os.path.join(path, name))
    R.spawn(fn, world, path, backend, device, *kw.values())
    prefix = {"mesh_rank": "mesh", "collectives_rank": "coll",
              "search_rank": "search"}[fn.__name__] + backend
    if fn.__name__ == "search_rank":
        prefix += device
    return [R.load(path, prefix, r) for r in range(world)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


#: the collective matmuls' block products are cuBLAS's on the card and the
#: CPU's own on the CPU, summed in other orders: held, as the reference's
#: ring_matmul_check.py holds them, within 1e-5
MATMULS = ("agmm", "ringmm")


def _assert_same(got, want, what):
    for key, v in want.items():
        if key == "staged" or key.startswith("launches_"):
            continue
        if key in MATMULS:
            np.testing.assert_allclose(got[key], v, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{what} {key}")
            continue
        np.testing.assert_array_equal(_bits(got[key]), _bits(v),
                                      err_msg=f"{what} {key}")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 2048 x 16 ``ip`` world of the CPU tests, 4 shards, its index
    built by the port on the CPU."""
    tmp = str(tmp_path_factory.mktemp("cudadist"))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2048, 16)).astype(np.float32)
    qs = rng.normal(size=(8, 16)).astype(np.float32)
    idx = T.build_sharded_index(X, 4, "ip", M=8, device="cpu")
    host = T.index_to_host(idx)
    np.savez(os.path.join(tmp, "world.npz"), X=X, qs=qs)
    np.savez(os.path.join(tmp, "index.npz"), meta_metric=np.asarray("ip"),
             meta_scale_rows=np.asarray(8),
             **{f: host[f] for f in ("vectors", "neighbors", "entries",
                                     "bases")})
    return tmp


@pytest.mark.parametrize("fn", ["mesh_rank", "collectives_rank"])
def test_gloo_ranks_sharing_the_card_equal_the_cpu(world, fn):
    fn = getattr(R, fn)
    cpu = _run(fn, 4, world, "share", "gloo", "cpu")
    card = _run(fn, 4, world, "share", "gloo", "cuda")
    for r in range(4):
        _assert_same(card[r], cpu[r], f"rank {r}")
        assert int(card[r]["staged"]) > 0


def test_gloo_sharded_topk_on_the_card_equals_the_cpu(world):
    """Each rank's beams and butterfly rounds run on the kernels."""
    cpu = _run(R.search_rank, 4, world, "topk", "gloo", "cpu", what="topk")
    card = _run(R.search_rank, 4, world, "topk", "gloo", "cuda",
                what="topk")
    for r in range(4):
        _assert_same(card[r], cpu[r], f"rank {r}")
        # two sharded_topk calls: the tournament's 2 rounds, one merge each
        assert int(card[r]["launches_topk_merge"]) == 2
        assert int(card[r]["launches_batch_similarity_gather"]) > 0


@pytest.mark.parametrize("fn", ["mesh_rank", "collectives_rank"])
def test_nccl_world_size_one_equals_gloo(world, fn):
    fn = getattr(R, fn)
    cpu = _run(fn, 1, world, "one", "gloo", "cpu")
    card = _run(fn, 1, world, "one", "nccl", "cuda")
    _assert_same(card[0], cpu[0], "rank 0")


def test_nccl_one_card_per_rank(world):
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL across cards needs two cards or more")
    world_size = 2 if torch.cuda.device_count() < 4 else 4
    for fn in (R.mesh_rank, R.collectives_rank):
        cpu = _run(fn, world_size, world, "across", "gloo", "cpu")
        card = _run(fn, world_size, world, "across", "nccl", "cuda")
        for r in range(world_size):
            _assert_same(card[r], cpu[r], f"{fn.__name__} rank {r}")
    if world_size == 4:
        cpu = _run(R.search_rank, 4, world, "across", "gloo", "cpu",
                   what="topk")
        card = _run(R.search_rank, 4, world, "across", "nccl", "cuda",
                    what="topk")
        for r in range(4):
            _assert_same(card[r], cpu[r], f"rank {r}")


def test_which_gloo_collectives_take_cuda_tensors(tmp_path):
    """Recorded, not required: which of gloo's collectives take a CUDA
    tensor as it is (``ProcessGroupMesh`` stages the others through host
    memory). Run with ``-s`` to read the outcome."""
    import json

    R.spawn(R.gloo_cuda_probe_rank, 2, str(tmp_path))
    for r in range(2):
        with open(tmp_path / f"probe_{r}.json") as f:
            got = json.load(f)
        print(f"rank {r}: {got}")
        assert set(got) == {"all_reduce", "all_gather", "broadcast"}


def test_facade_over_gloo_ranks_on_the_card_equals_local_mesh(tmp_path):
    """``tests/test_torch_sharded_db.py``'s drivers over 4 gloo ranks
    sharing the card (``rank_run``: the sharded facade's reads, float and
    int8; writes and a swap; the engine-direct grow and shrink; the elastic
    facade under a burst) equal the same drivers on a ``LocalMesh`` facade
    on the card bit for bit; a background rebuild over the ranks holds the
    validity gates with one swap on every rank."""
    import pickle

    import test_torch_sharded_db as t

    R.spawn(R.sharded_db_rank, 4, str(tmp_path), "gloo", "cuda",
            timeout=600)
    ranks = []
    for r in range(4):
        with open(tmp_path / f"dbgloocuda_{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    local = t.local_run("cuda")
    for part in t.RANK_PARTS:
        want = local[part]
        t._bit_equal(ranks[0][part], want, part)
    assert {g["epoch"] for g in ranks[0]["background"]} == {0, 1}
    for r in range(1, 4):
        assert ranks[r]["background"] == dict(swaps=[1]), r


def test_tensor_parallel_decode_on_the_card_equals_one_process(tmp_path):
    """(1, 2) over gloo ranks sharing the card against one process on the
    card, from the same seeded parameters and prompts."""
    from repro_torch.models import model as M

    cfg = R.tp_config("qwen2-1.5b")
    host = M.to_host(M.init_params(cfg, 7, "cpu"))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    arrays = {"b/tokens": toks, "b/labels": labels}
    for key, a in R._flat(host):
        arrays["p/" + "/".join(key)] = (a.view(np.uint16) if a.dtype.name
                                        in ("bfloat16", "uint16") else a)
    np.savez(tmp_path / "tp_in.npz", **arrays)
    R.spawn(R.tp_card_rank, 2, str(tmp_path))
    got = R.load(str(tmp_path), "tpcard", 0)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    want = R.tp_steps(cfg, host, batch, None, device="cuda")
    for what in ("prefill", "decode"):
        w = want[what].cpu().numpy()
        top = float(np.abs(w).max())
        tol = 4 * 2.0 ** (np.floor(np.log2(top)) - 7)
        np.testing.assert_allclose(got[what], w, rtol=0, atol=tol,
                                   err_msg=what)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4)


def test_ssm_tensor_parallel_decode_on_the_card_equals_one_process(tmp_path):
    """The reduced mamba2 on (1, 2) over gloo ranks sharing the card
    against one process on the card: prefill and 4 decode steps' logits
    within 4 bf16 ulps, the train step's loss at rtol 1e-4, and the rank's
    module gathered whole (``to_host``) bit for bit."""
    from repro_torch.models import model as M

    arch = "mamba2-370m"
    cfg = R.tp_config(arch)
    host = M.to_host(M.init_params(cfg, 7, "cpu"))
    rng = np.random.default_rng(8)
    arrays = {
        f"{arch}/b/tokens": rng.integers(0, cfg.vocab_size, (
            R.TPF_B, R.TPF_S)).astype(np.int32),
        f"{arch}/b/labels": rng.integers(0, cfg.vocab_size, (
            R.TPF_B, R.TPF_S)).astype(np.int32)}
    for key, a in R._flat(host):
        arrays[f"{arch}/p/" + "/".join(key)] = (
            a.view(np.uint16) if a.dtype.name in ("bfloat16", "uint16")
            else a)
    np.savez(tmp_path / "tpf_in.npz", **arrays)
    R.spawn(R.tpf_card_rank, 2, str(tmp_path))
    got = R.load(str(tmp_path), "tpfcard", 0)
    host, batch, cross = R.tpf_inputs(arrays, arch)
    want = R.tpf_steps(cfg, host, batch, cross, None, device="cuda")
    assert bool(got["to_host_equal"])
    for what in ("prefill", "decode"):
        w = want[what].cpu().numpy()
        top = float(np.abs(w).max())
        tol = 4 * 2.0 ** (np.floor(np.log2(top)) - 7)
        np.testing.assert_allclose(got[what], w, rtol=0, atol=tol,
                                   err_msg=what)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4)
