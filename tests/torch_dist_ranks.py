"""The rank bodies of the process-group tests, and the spawner that runs
them (``tests/test_torch_process_mesh.py``, ``test_torch_dist_*.py``,
``test_torch_cuda_dist.py``).

Nothing here imports JAX: ``torch.multiprocessing`` spawns each rank as a
fresh interpreter that imports this module (not the test module, which
imports the reference). Every rank sets one thread, joins a gloo (or
NCCL) group through a ``file://`` store under the test's temporary
directory (no TCP port, so parallel test workers cannot collide) with a
timeout of :data:`GROUP_TIMEOUT_S`, and writes what it computed to
``<tmp>/<tag>_<rank>.npz`` for the test to compare. A rank that raises
fails :func:`spawn`, which also kills ranks that outlive its deadline.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

GROUP_TIMEOUT_S = 60


def spawn(fn, world: int, *args, timeout: float = 240.0) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks; raise if
    one raises or they are not done within ``timeout`` seconds."""
    wait(start(fn, world, *args), timeout)


def start(fn, world: int, *args):
    """Start ``fn(rank, world, *args)`` on ``world`` spawned ranks; returns
    the context :func:`wait` takes."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world,) + args, nprocs=world,
                             join=False, start_method="spawn")
    ctx.started = time.monotonic()
    ctx.what = f"{fn.__name__} on {world} ranks"
    return ctx


def wait(ctx, timeout: float = 240.0) -> None:
    """Wait for the ranks of :func:`start`; raise if one raises or they are
    not done within ``timeout`` seconds of their start."""
    deadline = ctx.started + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            kill(ctx)
            raise TimeoutError(f"{ctx.what}: not done in {timeout} s")


def kill(ctx) -> None:
    for p in ctx.processes:
        if p.is_alive():
            p.kill()


def process_mesh(rank: int, world: int, tmp: str, tag: str, shape=None,
                 axes=("data",), backend: str = "gloo", device="cpu"):
    """This rank's ``ProcessGroupMesh`` (the default group made first)."""
    torch.set_num_threads(1)
    from repro_torch.compat import make_process_mesh

    return make_process_mesh(
        shape or (world,), axes, backend=backend,
        init_method="file://" + os.path.join(tmp, f"{tag}.store"),
        rank=rank, world_size=world, timeout_s=GROUP_TIMEOUT_S,
        device=device)


def rank_device(rank: int, world: int, backend: str, device: str
                ) -> torch.device:
    """``device`` for this rank: NCCL across ranks takes one card each
    (``cuda:rank``); gloo ranks on ``cuda`` share card 0."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if backend == "nccl" and world > 1:
            dev = torch.device("cuda", rank)
        elif dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    return dev


def save(tmp: str, tag: str, rank: int, **arrays) -> None:
    np.savez(os.path.join(tmp, f"{tag}_{rank}.npz"), **{
        k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in arrays.items()})


def load(tmp: str, tag: str, rank: int) -> dict:
    with np.load(os.path.join(tmp, f"{tag}_{rank}.npz")) as f:
        return dict(f)


def done() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------ the mesh ----
def mesh_inputs(world: int, device="cpu") -> dict:
    """Integer-valued float32 and int32 blocks, one per rank, so every
    sum is exact in any order."""
    rng = np.random.default_rng(world)
    f = rng.integers(-50, 50, (world, 3, 5)).astype(np.float32)
    i = rng.integers(-1000, 1000, (world, 4)).astype(np.int32)
    return dict(f=torch.from_numpy(f).to(device),
                i=torch.from_numpy(i).to(device))


#: the exchanges each rank runs: name -> the coordinate it receives from
def exchanges(p: int) -> dict:
    out = {"ring_next": lambda c: (c + 1) % p,
           "ring_prev": lambda c: (c - 1) % p}
    s = 1
    while s < p:
        out[f"xor{s}"] = lambda c, s=s: c ^ s
        s *= 2
    return out


def mesh_ops(mesh, x: dict, r: int) -> dict:
    """Every collective of a 1-D mesh on this rank's blocks."""
    out = {}
    for name, t in x.items():
        blk = t[r:r + 1]
        out[f"psum_{name}"] = mesh.psum(blk)
        out[f"pmax_{name}"] = mesh.pmax(blk)
        for axis in range(t.dim()):
            out[f"gather{axis}_{name}"] = mesh.all_gather(blk, axis=axis)
        for ex, src in exchanges(mesh.size).items():
            out[f"{ex}_{name}"] = mesh.exchange(blk, src)
    out["axis_index"] = mesh.axis_index()
    out["bcast"] = np.asarray(mesh.broadcast_object(
        {"from": int(mesh.rank), "v": [1, 2]} if mesh.rank == 0 else None
    )["from"])
    return out


def mesh_rank(rank: int, world: int, tmp: str, backend: str = "gloo",
              device: str = "cpu") -> None:
    """The 1-D mesh's collectives; with 4 ranks also the (2, 2) test mesh
    and the (2, 1, 2) pod mesh, along each of their axes."""
    dev = rank_device(rank, world, backend, device)
    mesh = process_mesh(rank, world, tmp, f"mesh{backend}", backend=backend,
                        device=dev)
    x = mesh_inputs(world, dev)
    out = mesh_ops(mesh, x, rank)
    if world == 4:
        from repro_torch.launch.mesh import batch_axes, make_test_mesh

        m2 = make_test_mesh(2, 2, device=dev)
        out["coords_2x2"] = np.asarray(m2.coords)
        out["batch_axes_2x2"] = np.asarray(batch_axes(m2))
        blk = x["f"][rank:rank + 1]
        for ax in ("data", "model"):
            out[f"psum_{ax}"] = m2.psum(blk, ax)
            out[f"gather_{ax}"] = m2.all_gather(blk, axis=1, axis_name=ax)
            out[f"xor_{ax}"] = m2.exchange(blk, lambda c: c ^ 1, ax)
            out[f"index_{ax}"] = m2.axis_index(ax)
        pod = make_test_mesh(1, 2, pod=2, device=dev)
        out["coords_pod"] = np.asarray(pod.coords)
        out["batch_axes_pod"] = np.asarray(batch_axes(pod))
        out["psum_pod"] = pod.psum(blk, "pod")
        out["staged"] = np.asarray(mesh.staged_bytes + m2.staged_bytes)
    save(tmp, f"mesh{backend}", rank, **out)
    done()


# ------------------------------------------------------- collectives ----
def collectives_inputs(device="cpu"):
    """The reference script's inputs (``compression_check.py`` and
    ``ring_matmul_check.py`` shapes, plus a ragged leaf and a dict)."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(4, 512)).astype(np.float32)
    g2 = rng.normal(size=(4, 512)).astype(np.float32)
    r = (rng.normal(size=(4, 3, 1000)) * 3).astype(np.float32)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    w = rng.normal(size=(32, 8)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device)
            for k, v in dict(g=g, g2=g2, r=r, x=x, w=w).items()}


def collectives_ops(mesh, a: dict, sl: slice) -> dict:
    """Two rounds of ``compressed_psum`` (the second with the first's
    error feedback), ``tree_compressed_psum`` and both matmuls, on the
    local stack ``sl`` of the inputs."""
    from repro_torch.distributed.collectives import (allgather_matmul,
                                                     ring_allgather_matmul)
    from repro_torch.distributed.compression import (compressed_psum,
                                                     tree_compressed_psum)

    out = {}
    mean, ef = compressed_psum(a["g"][sl], mesh)
    mean2, ef2 = compressed_psum(a["g2"][sl], mesh, ef=ef)
    out.update(mean=mean, ef=ef, mean2=mean2, ef2=ef2)
    tm, te = tree_compressed_psum({"g": a["g"][sl], "r": a["r"][sl]}, mesh)
    out.update(tree_g=tm["g"], tree_r=tm["r"], tree_ef_r=te["r"])
    xs = a["x"].reshape(4, 4, 32)[sl]
    out["agmm"] = allgather_matmul(xs, a["w"], mesh)
    out["ringmm"] = ring_allgather_matmul(xs, a["w"], mesh)
    return out


def collectives_rank(rank: int, world: int, tmp: str, backend: str = "gloo",
                     device: str = "cpu") -> None:
    dev = rank_device(rank, world, backend, device)
    mesh = process_mesh(rank, world, tmp, f"coll{backend}", backend=backend,
                        device=dev)
    out = collectives_ops(mesh, collectives_inputs(dev),
                          slice(rank, rank + 1))
    out["staged"] = np.asarray(mesh.staged_bytes)
    save(tmp, f"coll{backend}", rank, **out)
    done()


# ------------------------------------------------------------ search ----
def load_host_index(path: str) -> dict:
    with np.load(path, allow_pickle=False) as f:
        host = {k: f[k] for k in f.files if not k.startswith("meta_")}
        meta = {k[5:]: f[k].item() for k in f.files if k.startswith("meta_")}
    host.update(metric=str(meta["metric"]), scheme=None,
                scale_rows=int(meta.get("scale_rows", 8)))
    return host


def search_ops(index, X, qs, mesh, lanes: int = 3) -> dict:
    """``sharded_topk`` (both merges), two rounds of
    ``sharded_topk_resume``, ``sharded_diverse_search``,
    ``sharded_progressive_diverse`` and a
    ``LaneScheduler`` over a ``lanes``-lane ``ShardedEngine`` serving every
    query (more queries than lanes: admission in the middle of the run)."""
    from repro_torch import sharded_search as T

    out = {}
    for merge in ("tournament", "allgather"):
        r = T.sharded_topk(index, qs, 10, 64, mesh, merge=merge,
                           with_expansions=True)
        for name, a in zip(("ids", "scores", "expansions"), r):
            out[f"topk_{merge}_{name}"] = a
    B = qs.shape[0]
    cap = T.beam_state_capacity(index, 64)
    state = T.init_sharded_state(index, B, cap, mesh)
    lanes_all = np.arange(B)
    ids, sc, state = T.sharded_topk_resume(index, state, qs, lanes_all,
                                           np.ones(B, bool), 16, 64, mesh)
    out.update(resume1_ids=ids, resume1_scores=sc)
    half = lanes_all[::2]
    ids, sc, state = T.sharded_topk_resume(index, state, qs[half], half,
                                           np.zeros(len(half), bool), 32,
                                           128, mesh)
    out.update(resume2_ids=ids, resume2_scores=sc,
               resume2_steps=mesh.psum(state.steps))
    r = T.sharded_diverse_search(index, X, qs, 5, 4.0, 64, mesh,
                                 with_expansions=True)
    for name, a in zip(("ids", "scores", "certified", "expansions"), r):
        out["diverse_" + name] = a
    r = T.sharded_progressive_diverse(index, X, qs, 5, 4.0, mesh, K0=16)
    for name, a in zip(("ids", "scores", "certified", "K_final"), r):
        out[f"progressive_beam_{name}"] = a
    out.update(scheduled(index, X, qs, mesh, lanes))
    return out


def scheduled(index, X, qs, mesh, lanes: int) -> dict:
    """Rank 0's ``LaneScheduler`` results (the other ranks follow and
    return nothing): per request ids, scores, certificate, K_final,
    expansions, and whether a request was admitted into a freed lane while
    others were in flight."""
    from repro_torch.serve.scheduler import LaneScheduler, follow
    from repro_torch.sharded_search import ShardedEngine

    eng = ShardedEngine(index, X, mesh, num_lanes=lanes, K0=16, max_k=8,
                        resume="beam")
    if getattr(mesh, "local_size", 1) != mesh.size and mesh.rank != 0:
        follow(eng)
        return {}
    sched = LaneScheduler(backend=eng, prewarm=True, max_pending=64)
    reqs = [sched.submit(np.asarray(q.cpu() if isinstance(q, torch.Tensor)
                                    else q), 5, 4.0) for q in qs]
    mid_run = False
    seen: dict[int, int] = {}
    while sched.pending or sched.inflight:
        before = {lane: r.rid for lane, r in sched.inflight.items()}
        sched.pump()
        for lane, r in sched.inflight.items():
            if before.get(lane) != r.rid and lane in seen and before:
                mid_run = True
            seen[lane] = r.rid
    sched.close()
    res = [r.result for r in reqs]
    return dict(
        sched_ids=np.stack([x.ids for x in res]),
        sched_scores=np.stack([x.scores for x in res]),
        sched_certified=np.array([x.stats.certified for x in res]),
        sched_K_final=np.array([x.stats.K_final for x in res]),
        sched_expansions=np.array([x.stats.expansions for x in res]),
        sched_mid_run=np.asarray(mid_run),
        sched_latency_n=np.asarray(sched.latency_stats()["completed"]))


def search_rank(rank: int, world: int, tmp: str, backend: str = "gloo",
                device: str = "cpu", what: str = "all") -> None:
    """This rank's shard of the index in ``<tmp>/index.npz`` (queries and
    corpus in ``<tmp>/world.npz``) and the search calls of
    :func:`search_ops` (``what="topk"``: ``sharded_topk`` only), with each
    rank's kernel launches by name."""
    dev = rank_device(rank, world, backend, device)
    mesh = process_mesh(rank, world, tmp, f"search{backend}{device}",
                        backend=backend, device=dev)
    from repro_torch.kernels import ops
    from repro_torch.sharded_search import search as ss

    host = load_host_index(os.path.join(tmp, "index.npz"))
    index = ss.index_from_host(ss.local_shard(host, rank), device=dev)
    with np.load(os.path.join(tmp, "world.npz")) as f:
        X, qs = torch.from_numpy(f["X"]).to(dev), torch.from_numpy(f["qs"])
    ops.reset_launch_counts()
    if what == "topk":
        out = {}
        for merge in ("tournament", "allgather"):
            r = ss.sharded_topk(index, qs, 10, 64, mesh, merge=merge,
                                with_expansions=True)
            for name, a in zip(("ids", "scores", "expansions"), r):
                out[f"topk_{merge}_{name}"] = a
    else:
        out = search_ops(index, X, qs, mesh)
    out.update({f"launches_{k}": np.asarray(v)
                for k, v in ops.launch_counts().items()})
    out["staged"] = np.asarray(mesh.staged_bytes)
    save(tmp, f"search{backend}{device}", rank, **out)
    done()


def sharded_db_rank(rank: int, world: int, tmp: str, backend: str = "gloo",
                    device: str = "cpu") -> None:
    """``tests/test_torch_sharded_db.py``'s drivers on facades and engines
    over the group (``rank_run`` there): rank 0 drives, the others follow.
    Writes ``<tmp>/db<backend><device>_<rank>.pkl``."""
    import pickle

    dev = rank_device(rank, world, backend, device)
    tag = f"db{backend}{device}"
    mesh = process_mesh(rank, world, tmp, tag, backend=backend, device=dev)
    import test_torch_sharded_db as t      # JAX-free at import

    out = t.rank_run(mesh, dev)
    with open(os.path.join(tmp, f"{tag}_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    done()


# ------------------------------------------------------------- train ----
def train_rank(rank: int, world: int, tmp: str) -> None:
    """One data-parallel train step of the reduced qwen2 on a ``(world,
    1)`` mesh from the parameters and batch in ``<tmp>/train_in.npz``."""
    mesh = process_mesh(rank, world, tmp, "train", shape=(world, 1),
                        axes=("data", "model"))
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O

    cfg = get_config("qwen2-1.5b").reduced()
    with np.load(os.path.join(tmp, "train_in.npz")) as f:
        arrays = dict(f)
    params = M.from_host(cfg, _tree(arrays, "p/"), device="cpu")
    batch = {k: torch.from_numpy(arrays["b/" + k]) for k in ("tokens",
                                                              "labels")}
    opt = O.AdamW(lr=O.cosine_schedule(3e-3, 1, 12))
    step, _ = build_train_step(cfg, mesh, optimizer=opt)
    params, state, loss = step(params, opt.init(params), batch)
    if rank == 0:
        flat = {"p/" + "/".join(k): v for k, v in _flat(M.to_host(params))}
        save(tmp, "train", rank, loss=loss, **{
            k: (v.view(np.uint16) if v.dtype.name == "bfloat16" else v)
            for k, v in flat.items()})
    done()


def _flat(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree(arrays: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in arrays.items():
        if not key.startswith(prefix):
            continue
        path = key[len(prefix):].split("/")
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def reshard_rank(rank: int, world: int, tmp: str) -> None:
    """``reshard_tree`` of the reduced qwen2's parameters (the reference's
    checkpoint in ``<tmp>/ref_ckpt``) onto a (2, 2) mesh, then to (4, 1)
    and back; rank 0 writes the (2, 2) slices gathered whole as a
    checkpoint of its own (``<tmp>/port_ckpt``)."""
    mesh22 = process_mesh(rank, world, tmp, "reshard", shape=(2, 2),
                          axes=("data", "model"))
    from repro_torch.compat import ProcessGroupMesh
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt

    mesh41 = ProcessGroupMesh((4, 1), ("data", "model"), device="cpu")
    cfg = get_config("qwen2-1.5b").reduced()
    like = M.stack(M.abstract_params(cfg).to_empty(device="cpu")
                   .named_parameters())
    whole = ckpt.restore(os.path.join(tmp, "ref_ckpt"), 1, like)
    s22 = reshard_tree(whole, mesh22, cfg)
    s41 = reshard_tree(s22, mesh41, cfg, old_mesh=mesh22)
    back = reshard_tree(s41, mesh22, cfg, old_mesh=mesh41)
    spec22 = sh.param_spec_tree(cfg, sh.param_layout(whole), mesh22)
    gathered = {}

    def walk(a, b, c, spec, path=()):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], c[k], spec[k], path + (k,))
            else:
                gathered["/".join(path + (k,))] = sh.gather_leaf(
                    c[k], spec[k], mesh22)
                assert torch.equal(a[k].view(torch.int16) if a[k].dtype ==
                                   torch.bfloat16 else a[k],
                                   b[k].view(torch.int16) if b[k].dtype ==
                                   torch.bfloat16 else b[k]), path + (k,)

    walk(s22, back, s22, spec22)
    shapes = {"/".join(p): np.asarray(v.shape) for p, v in _flat(s41)}
    if rank == 0:
        whole22 = _tree(gathered, "")
        ckpt.save(os.path.join(tmp, "port_ckpt"), 1, whole22)
    save(tmp, "reshard", rank, **{"s41/" + k: v for k, v in shapes.items()})
    mesh22.barrier()
    done()


def loop_rank(rank: int, world: int, tmp: str) -> None:
    """``launch.train.main`` under torchrun's variables: two ranks train
    the reduced qwen2 data parallel for 4 steps with a checkpoint every
    step and a fault injected at step 2 on every rank."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    from repro_torch.launch import train as launcher
    from repro_torch.train import loop

    reports = []
    real = loop.train

    def traced(*a, **kw):
        fired = []

        def hook(step):
            if step == 2 and not fired:
                fired.append(step)
                raise RuntimeError("injected fault")

        rep = real(*a, fault_hook=hook, **kw)
        reports.append(rep)
        return rep

    launcher.train = traced
    rc = launcher.main(["--steps", "4", "--batch", "4", "--seq", "16",
                        "--ckpt", os.path.join(tmp, "loop_ckpt"),
                        "--ckpt-every", "1", "--device", "cpu",
                        "--backend", "gloo", "--init-method",
                        "file://" + os.path.join(tmp, "loop.store")])
    rep = reports[0]
    save(tmp, "loop", rank, rc=rc, losses=np.asarray(rep.losses),
         restarts=rep.restarts, steps_run=rep.steps_run)


def gloo_cuda_probe_rank(rank: int, world: int, tmp: str) -> None:
    """Which of gloo's collectives take CUDA tensors as they are: each is
    tried once on the card and its outcome (or error) recorded. Point to
    point is not tried: gloo's TCP pair writes a CUDA tensor's device
    pointer and the process aborts (``gloo::IoException``, ``writev ...
    Bad address``, torch 2.11 on an H100)."""
    dev = rank_device(rank, world, "gloo", "cuda")
    process_mesh(rank, world, tmp, "probe", device=dev)
    import json

    import torch.distributed as dist

    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 — the probe records each error
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
        with open(os.path.join(tmp, f"probe_{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    done()


# ------------------------------------------------------------- serve ----
#: the launcher's arguments in ``tests/test_torch_dist_serve.py``
SERVE_ARGS = ["--corpus", "1000", "--requests", "4", "--steps", "4",
              "--device", "cpu"]
SERVE_MODES = {"mesh": ["--mesh-shards", "4"], "elastic": ["--elastic"]}


def recorded_pipeline(launcher, into: dict):
    """Make ``launcher.RagPipeline`` keep what ``generate`` returns in
    ``into`` (tokens, ids, certified)."""
    real = launcher.RagPipeline

    class Recording(real):
        def generate(self, *a, **kw):
            out = super().generate(*a, **kw)
            into.update(tokens=out[0], ids=out[1], certified=out[2])
            return out

    launcher.RagPipeline = Recording
    return real


def serve_rank(rank: int, world: int, tmp: str) -> None:
    """``launch.serve.main`` under torchrun's variables, with each of
    :data:`SERVE_MODES` (rank 0 records its retrieval and tokens), then
    ``compat.device_count()`` and a ``shards="auto"`` facade inside a
    default group of the ranks."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    from repro_torch import compat
    from repro_torch.launch import serve as launcher

    rec: dict = {}
    recorded_pipeline(launcher, rec)
    out = {}
    for mode, flags in SERVE_MODES.items():
        rec.clear()
        out[f"{mode}_rc"] = launcher.main(
            SERVE_ARGS + flags + ["--backend", "gloo", "--init-method",
                                  "file://" + os.path.join(
                                      tmp, f"serve{mode}.store")])
        for k, v in rec.items():
            out[f"{mode}_{k}"] = v
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        del os.environ[k]
    out["outside"] = compat.device_count()
    process_mesh(rank, world, tmp, "auto")
    out["inside"] = compat.device_count()
    from repro_torch.db import DiverseVectorDB

    x = np.random.default_rng(0).normal(size=(512, 16)).astype(np.float32)
    db = DiverseVectorDB(x, "ip", shards="auto", num_lanes=2, max_k=8, M=8,
                         prewarm=False, device="cpu")
    if rank == 0:
        res = db.search(x[3], k=5, eps=4.0)
        out.update(auto_shards=db.backend.num_shards, auto_world=db.world.size,
                   auto_ids=res.ids, auto_scores=res.scores)
        db.close()
    save(tmp, "serve", rank, **out)
    done()


# --------------------------------------------------- tensor parallel ----
#: the meshes of ``tests/test_torch_tensor_parallel.py``: tag -> (shape,
#: axes); the 2-rank meshes are the first two ranks' (``sub``)
TP_MESHES = {"1x2": ((1, 2), ("data", "model")),
             "2x2": ((2, 2), ("data", "model")),
             "1x4": ((1, 4), ("data", "model")),
             "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
#: the MoE's meshes and dispatches
TP_MOE = {"2x1_sort": ((2, 1), "sort"), "2x1_einsum": ((2, 1), "einsum"),
          "1x2_sort": ((1, 2), "sort"), "1x2_einsum": ((1, 2), "einsum")}
#: the reduced configs' vocabulary made even, so that it splits over m
TP_VOCAB = 504
TP_DECODE_STEPS = 4
#: the capacity factor of the MoE's direct calls: these inputs drop pairs
TP_MOE_CF = 0.5
TP_LOOP_STEPS = 3


def tp_config(arch: str):
    """The port's reduced config of ``arch`` with :data:`TP_VOCAB`."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(),
                               vocab_size=TP_VOCAB)


def tp_optimizer(total: int = 12, warmup: int = 1):
    from repro_torch.train import optimizer as O
    return O.AdamW(lr=O.cosine_schedule(3e-3, warmup, total))


def tp_steps(cfg, host: dict, batch: dict, mesh, opts=None,
             device="cpu") -> dict:
    """The prefill logits, :data:`TP_DECODE_STEPS` decode steps' logits
    (the prompt's tokens fed one a step) and one AdamW step (its loss and
    the updated parameters, gathered whole) of ``cfg`` on ``mesh`` (None:
    one process) from the reference's parameters ``host``, on ``device``."""
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M

    params = M.from_host(cfg, host, device=device, mesh=mesh)
    batch = {k: v.to(device) for k, v in batch.items()}
    toks = batch["tokens"]
    prefill, _ = S.build_prefill_step(cfg, mesh, opts=opts)
    serve, _ = S.build_serve_step(cfg, mesh)
    out = {"prefill": prefill(params, {"tokens": toks})}
    cache = M.init_cache(cfg, toks.shape[0], TP_DECODE_STEPS, device=device,
                         mesh=mesh)
    dec = []
    for t in range(TP_DECODE_STEPS):
        logits, cache = serve(params, cache, toks[:, t:t + 1])
        dec.append(logits)
    out["decode"] = torch.cat(dec, 1)
    opt = tp_optimizer()
    step, _ = S.build_train_step(cfg, mesh, optimizer=opt, opts=opts)
    params, _, loss = step(params, opt.init(params), batch)
    out["loss"] = loss
    for key, v in _flat(M.to_host(params)):
        out["p/" + "/".join(key)] = (v.view(np.uint16)
                                     if v.dtype.name == "bfloat16" else v)
    return out


class RouteRecorder:
    """Records, for each MoE call, the experts ``moe.route`` picks and the
    keep mask the dispatch uses (``moe.place``'s over data ranks, else
    ``route``'s; ``group_ranks``'s for ``"einsum"``)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.real = moe, (moe.route, moe.place, moe.group_ranks)
        self.experts, self.keeps = [], []

    def __enter__(self):
        route, place, group = self.real

        def rec_route(*a):
            out = route(*a)
            self.experts.append(out[2])
            self.keeps.append(out[4])
            return out

        def rec_place(*a):
            out = place(*a)
            self.keeps[-1] = out[1]
            return out

        def rec_group(*a):
            out = group(*a)
            self.keeps[-1] = out[1]
            return out

        self.moe.route, self.moe.place, self.moe.group_ranks = (
            rec_route, rec_place, rec_group)
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.place, self.moe.group_ranks = self.real


def tp_moe(cfg, host: dict, batch: dict, x, mesh, impl: str) -> dict:
    """The MoE on ``mesh`` (None: one process) with dispatch ``impl``: one
    ``moe_ffn`` call of the first block on the rank's rows of ``x`` at
    :data:`TP_MOE_CF` (its output, load-balance share, experts and keep
    mask), and one train step's loss."""
    from repro_torch.distributed.tensor_parallel import data_ranks
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.models import moe

    params = M.from_host(cfg, host, device="cpu", mesh=mesh)
    dp = data_ranks(mesh)
    xs = x if dp is None else x[dp.rows(x.shape[0])]
    with RouteRecorder() as rec:
        y, aux = moe.moe_ffn(params.blocks[0].moe, xs,
                             num_experts=cfg.num_experts,
                             experts_per_token=cfg.experts_per_token,
                             capacity_factor=TP_MOE_CF, act=cfg.mlp_act,
                             impl=impl, mp=params.mp, dp=dp)
    opt = tp_optimizer()
    step, _ = S.build_train_step(cfg, mesh, optimizer=opt,
                                 opts={"moe_impl": impl})
    _, _, loss = step(params, opt.init(params), batch)
    return dict(y=y.float(), aux=aux, expert=rec.experts[0],
                keep=rec.keeps[0], loss=loss)


def tp_rank(rank: int, world: int, tmp: str) -> None:
    """``tests/test_torch_tensor_parallel.py`` on one of 4 ranks: the
    dense steps on each of :data:`TP_MESHES` (the rank 0 of each mesh
    writes), the MoE on the first two ranks, then ``train.loop.train`` on
    (2, 2) with a checkpoint each step and a fault at step 2 on every
    rank. Inputs in ``<tmp>/tp_in.npz``; writes ``<tmp>/tp_<rank>.npz``."""
    mesh4 = process_mesh(rank, world, tmp, "tp")
    from repro_torch.train import loop

    with np.load(os.path.join(tmp, "tp_in.npz")) as f:
        arrays = dict(f)
    out = {}
    cfg = tp_config("qwen2-1.5b")
    host = _tree(arrays, "p/")
    batch = {k: torch.from_numpy(arrays["b/" + k]) for k in ("tokens",
                                                              "labels")}
    for tag, (shape, axes) in TP_MESHES.items():
        mesh = mesh4.sub(int(np.prod(shape)), shape, axes)
        if not mesh.member:
            continue
        res = tp_steps(cfg, host, batch, mesh)
        if mesh.rank == 0:
            out.update({f"{tag}/{k}": v for k, v in res.items()})
    mcfg = tp_config("moonshot-v1-16b-a3b")
    mhost = _tree(arrays, "q/")
    x = torch.from_numpy(arrays["x"].view(np.int16)).view(torch.bfloat16)
    for tag, (shape, impl) in TP_MOE.items():
        mesh = mesh4.sub(2, shape, ("data", "model"))
        if mesh.member:
            res = tp_moe(mcfg, mhost, batch, x, mesh, impl)
            out.update({f"{tag}/{k}": v for k, v in res.items()})
    mesh22 = mesh4.sub(4, (2, 2), ("data", "model"))
    fired = []

    def hook(step):
        if step == 2 and not fired:
            fired.append(step)
            raise RuntimeError("injected fault")

    rep = loop.train(cfg, mesh22, steps=TP_LOOP_STEPS, global_batch=4,
                     seq_len=16, ckpt_dir=os.path.join(tmp, "loop_ckpt"),
                     ckpt_every=1, optimizer=tp_optimizer(TP_LOOP_STEPS, 0),
                     fault_hook=hook, log_every=0, device="cpu")
    out.update({"loop/losses": np.asarray(rep.losses),
                "loop/restarts": rep.restarts})
    save(tmp, "tp", rank, **out)
    done()


def tp_card_rank(rank: int, world: int, tmp: str) -> None:
    """``tests/test_torch_cuda_dist.py``: :func:`tp_steps` of the reduced
    qwen2 on a (1, 2) mesh of gloo ranks sharing card 0, from the
    parameters and batch in ``<tmp>/tp_in.npz``; rank 0 writes."""
    dev = rank_device(rank, world, "gloo", "cuda")
    mesh = process_mesh(rank, world, tmp, "tpcard", shape=(1, world),
                        axes=("data", "model"), device=dev)
    with np.load(os.path.join(tmp, "tp_in.npz")) as f:
        arrays = dict(f)
    batch = {k: torch.from_numpy(arrays["b/" + k]) for k in ("tokens",
                                                              "labels")}
    out = tp_steps(tp_config("qwen2-1.5b"), _tree(arrays, "p/"), batch,
                   mesh, device=dev)
    if rank == 0:
        save(tmp, "tpcard", rank, **out)
    done()


# ---------------------------------- tensor parallel: the other families ----
#: ``tests/test_torch_tp_families.py``'s archs (reduced, TP_VOCAB) and the
#: meshes each runs on: tag -> (shape, axes)
TPF_ARCHS = ("mamba2-370m", "recurrentgemma-9b", "whisper-small",
             "llama-3.2-vision-90b")
TPF_MESHES = {"1x2": ((1, 2), ("data", "model")),
              "2x2": ((2, 2), ("data", "model")),
              "1x4": ((1, 4), ("data", "model"))}
#: the (arch, mesh tag) cases: every arch on (1, 2) and (2, 2), the ssm
#: and hybrid also on (1, 4)
TPF_CASES = tuple((a, t) for a in TPF_ARCHS for t in TPF_MESHES
                  if t != "1x4" or a in ("mamba2-370m", "recurrentgemma-9b"))
TPF_B, TPF_S = 4, 16
#: the arch ``train.loop.train`` runs on (1, 2), a fault and a restore
#: included (its part-wise leaves go through the checkpoint)
TPF_LOOP_ARCH = "mamba2-370m"
#: the float32 check: (arch, layers) trained one step on (1, 2) with every
#: parameter in float32, where no bf16 rounding can flip
TPF_F32 = (("mamba2-370m", 8), ("recurrentgemma-9b", 6))
#: vlm's cross gates in the tests' parameters (zeros would mute the
#: cross-attention)
TPF_GATE = 0.5


def tpf_local_cross(cache: dict, whole: dict, mesh) -> None:
    """Write this rank's part of the whole decode cross caches ``whole``
    (``cross_k`` / ``cross_v`` [L, B, T, KV, hd] tensors) into ``cache``
    (``models.model.init_cache(..., mesh=mesh)``'s): its rows over the
    data ranks and, where the cache holds fewer kv heads, its block of
    them."""
    from repro_torch.distributed.tensor_parallel import (MODEL, data_ranks,
                                                         model_axis)

    dp = data_ranks(mesh)
    for key, t in whole.items():
        if dp is not None:
            t = t[:, dp.rows(t.shape[1])]
        kv = cache[key].shape[-2]
        if kv != t.shape[-2]:
            i = mesh.coords[mesh.axis_names.index(MODEL)]
            assert kv * model_axis(mesh) == t.shape[-2]
            t = t.narrow(-2, i * kv, kv)
        cache[key].copy_(t)


def tpf_steps(cfg, host: dict, batch: dict, cross: dict, mesh,
              device="cpu") -> dict:
    """Whether ``to_host`` of the rank's module gives ``host`` back bit for
    bit, the prefill logits, :data:`TP_DECODE_STEPS` decode steps' logits
    (the prompt's tokens fed one a step, against the cross caches
    ``cross``) and one AdamW step (its loss, gradients and the updated
    parameters, gathered whole) of ``cfg`` on ``mesh`` (None: one process) from the
    reference's parameters ``host``, on ``device``."""
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M

    params = M.from_host(cfg, host, device=device, mesh=mesh)
    back = dict(_flat(M.to_host(params)))
    same = all(np.array_equal(np.asarray(back[k]).view(np.uint8),
                              np.asarray(v).view(np.uint8))
               for k, v in _flat(host))
    batch = {k: v.to(device) for k, v in batch.items()}
    toks = batch["tokens"]
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    out = {"to_host_equal": np.asarray(same and len(back) == len(
        list(_flat(host))))}
    prefill, _ = S.build_prefill_step(cfg, mesh)
    serve, _ = S.build_serve_step(cfg, mesh)
    out["prefill"] = prefill(params, inputs)
    cache = M.init_cache(cfg, toks.shape[0], TP_DECODE_STEPS, device=device,
                         mesh=mesh)
    tpf_local_cross(cache, {k: v.to(device) for k, v in cross.items()},
                    mesh)
    dec = []
    for t in range(TP_DECODE_STEPS):
        logits, cache = serve(params, cache, toks[:, t:t + 1])
        dec.append(logits)
    out["decode"] = torch.cat(dec, 1)
    opt = FirstGrads(tp_optimizer())
    step, _ = S.build_train_step(cfg, mesh, optimizer=opt)
    params, _, loss = step(params, opt.init(params), batch)
    out["loss"] = loss
    for key, v in _flat(M.to_host(params)):
        out["p/" + "/".join(key)] = (v.view(np.uint16)
                                     if v.dtype.name == "bfloat16" else v)
    for key, g in _flat(M.stack(M.whole(params, opt.first.items()))):
        out["g/" + "/".join(key)] = g.float()
    return out


def tpf_f32_grads(arch: str, layers: int, mesh) -> tuple:
    """(loss, {leaf path: gradient gathered whole}) of one train step of
    ``arch`` at ``layers`` layers with every parameter in float32 (the
    seeded init, a seeded batch of TPF_B x TPF_S) on ``mesh`` (None: one
    process)."""
    import dataclasses

    from repro_torch.launch import steps as S
    from repro_torch.models import model as M

    cfg = dataclasses.replace(tp_config(arch), dtype="float32",
                              num_layers=layers)
    params = M.init_params(cfg, 3, "cpu", mesh)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (TPF_B, TPF_S),
                              generator=gen) for k in ("tokens", "labels")}
    opt = FirstGrads(tp_optimizer())
    step, _ = S.build_train_step(cfg, mesh, optimizer=opt)
    _, _, loss = step(params, opt.init(params), batch)
    return float(loss), {"/".join(k): v.float() for k, v in _flat(
        M.stack(M.whole(params, opt.first.items())))}


class FirstGrads:
    """The optimizer a train step is given, keeping the gradients of its
    first update (``first``, by parameter name: the rank's slices)."""

    def __init__(self, opt):
        self.opt, self.first = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        if self.first is None:
            self.first = {k: g.detach().clone() for k, g in grads.items()}
        return self.opt.update(grads, state, params)


def tpf_inputs(arrays: dict, arch: str) -> tuple:
    """(host params, batch, cross caches) of ``arch`` from the test's
    arrays (bf16 as uint16 bits)."""
    def tensor(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.view(torch.bfloat16) if a.dtype == np.uint16 else t

    batch = {k: tensor(arrays[f"{arch}/b/{k}"]) for k in (
        "tokens", "labels", "frontend_embeds")
        if f"{arch}/b/{k}" in arrays}
    cross = {k: tensor(arrays[f"{arch}/c/{k}"]) for k in (
        "cross_k", "cross_v") if f"{arch}/c/{k}" in arrays}
    return _tree(arrays, f"{arch}/p/"), batch, cross


def tpf_rank(rank: int, world: int, tmp: str) -> None:
    """``tests/test_torch_tp_families.py`` on one of 4 ranks:
    :func:`tpf_steps` of each of :data:`TPF_CASES` (the rank 0 of each mesh
    writes), the float32 steps of :data:`TPF_F32` on (1, 2), then
    ``train.loop.train`` of :data:`TPF_LOOP_ARCH` on (1, 2) with a
    checkpoint each step and a fault at step 2. Inputs in ``<tmp>/tpf_in.npz``; writes
    ``<tmp>/tpf_<rank>.npz``."""
    mesh4 = process_mesh(rank, world, tmp, "tpf")
    with np.load(os.path.join(tmp, "tpf_in.npz")) as f:
        arrays = dict(f)
    meshes = {tag: mesh4.sub(int(np.prod(shape)), shape, axes)
              for tag, (shape, axes) in TPF_MESHES.items()}
    out = {}
    for arch, tag in TPF_CASES:
        mesh = meshes[tag]
        if not mesh.member:
            continue
        host, batch, cross = tpf_inputs(arrays, arch)
        res = tpf_steps(tp_config(arch), host, batch, cross, mesh)
        if mesh.rank == 0:
            out.update({f"{arch}/{tag}/{k}": v for k, v in res.items()})
    mesh = meshes["1x2"]
    for arch, layers in TPF_F32 if mesh.member else ():
        _, grads = tpf_f32_grads(arch, layers, mesh)
        if mesh.rank == 0:
            out.update({f"f32/{arch}/{k}": v for k, v in grads.items()})
    if mesh.member:
        from repro_torch.train import loop

        fired = []

        def hook(step):
            if step == 2 and not fired:
                fired.append(step)
                raise RuntimeError("injected fault")

        rep = loop.train(tp_config(TPF_LOOP_ARCH), mesh, steps=TP_LOOP_STEPS,
                         global_batch=TPF_B, seq_len=TPF_S,
                         ckpt_dir=os.path.join(tmp, "tpf_ckpt"),
                         ckpt_every=1,
                         optimizer=tp_optimizer(TP_LOOP_STEPS, 0),
                         fault_hook=hook, log_every=0, device="cpu")
        out.update({"loop/losses": np.asarray(rep.losses),
                    "loop/restarts": rep.restarts})
    save(tmp, "tpf", rank, **out)
    mesh4.barrier()
    done()


def tpf_card_rank(rank: int, world: int, tmp: str) -> None:
    """``tests/test_torch_cuda_dist.py``: :func:`tpf_steps` of the reduced
    mamba2 on a (1, 2) mesh of gloo ranks sharing card 0, from the inputs
    in ``<tmp>/tpf_in.npz`` (:func:`tpf_inputs`); rank 0 writes."""
    dev = rank_device(rank, world, "gloo", "cuda")
    mesh = process_mesh(rank, world, tmp, "tpfcard", shape=(1, world),
                        axes=("data", "model"), device=dev)
    with np.load(os.path.join(tmp, "tpf_in.npz")) as f:
        arrays = dict(f)
    arch = "mamba2-370m"
    host, batch, cross = tpf_inputs(arrays, arch)
    out = tpf_steps(tp_config(arch), host, batch, cross, mesh, device=dev)
    if rank == 0:
        save(tmp, "tpfcard", rank, **out)
    done()
