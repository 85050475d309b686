"""Serving launcher: diverse-retrieval RAG over a synthetic corpus (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 4 --k 5 --eps 3.0

Everything runs on ``--device`` (``cuda`` unless given): the facade's graph
and engine, and the model, with seeded random weights at the arch's reduced
config.

Requests flow through the continuous-batching lane scheduler
(``serve.scheduler.LaneScheduler``): per-request (k, eps), lane recycling on
certification, pre-warmed compile ladder; per-request latency and fairness
stats are printed after the run. ``--tenants N`` labels requests round-robin
across N tenants and ``--policy {fifo,drr,slo_cost}`` picks the cost-aware
admission policy scheduling across them (``serve.policies``); per-tenant
p50/p99 and the cross-tenant Jain index are printed when N > 1.

``--mesh-shards P`` serves retrieval off a P-way sharded device mesh
instead of the single-host engine: the corpus is partitioned across the
mesh's data axis and the *same* scheduler drives a
``sharded_search.engine.ShardedEngine`` backend (shard-local beams,
tournament merge, per-lane progressive budgets); in one process the mesh
is P shards on the one device (``compat.device_count()`` slots). ``--elastic`` instead
starts on half the available power-of-two devices and lets the scheduler
grow/shrink the shard count under sustained queue depth, migrating
in-flight lanes between rounds (contract 16).

Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` in the environment) the mesh
is one shard per rank: the process group is made with ``--backend`` (no
default: ``nccl`` with one card per rank, ``gloo`` on the CPU or with
ranks sharing a card) from torchrun's ``env://`` rendezvous (or
``--init-method``), each rank on ``cuda:LOCAL_RANK`` modulo the cards it
sees (with ``--device cuda``, the default), ``--mesh-shards P`` serves over
the group's first P ranks and ``--elastic`` starts on half of them. Rank 0
runs the pipeline and prints what one process prints; the other ranks
follow its facade until it closes:

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --backend gloo --mesh-shards 4

Without those variables nothing changes.

``--cache-size N`` enables the semantic result cache (``serve.cache``):
repeated or near-duplicate queries are answered from a certified cached
result set after a fresh Theorem-2 recheck, without occupying a lane.
``--cost-model-path f.json`` warm-starts the admission policies' expansion
cost model from a previous run and persists the learned state afterwards.

Serving is assembled through ``repro_torch.db.DiverseVectorDB`` (one
constructor: index → backend → scheduler → cache), which also provides
the write path: ``--upserts N`` interleaves N upserts and N deletes with
the request batch to exercise the delta segment, deletion bitmap, and
epoch swap, and prints the mutable-index stats afterwards.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.db import DiverseVectorDB
from repro_torch.models import model as M
from repro_torch.serve.policies import ExpansionCostModel
from repro_torch.serve.rag import RagPipeline


def _build_db(docs: np.ndarray, args, cost_model, world=None,
              device=None) -> DiverseVectorDB:
    """The facade the flags ask for; over ``world`` (a process group's
    mesh) on every rank, returning on the other ranks once rank 0 closed
    it."""
    n_dev = world.size if world is not None else compat.device_count()
    shards = args.mesh_shards or None
    if args.elastic:
        if args.mesh_shards:
            raise SystemExit("--elastic picks its own shard counts "
                             "(shards='auto'); drop --mesh-shards")
        if n_dev < 2:
            raise SystemExit("--elastic needs >= 2 devices")
        shards = "auto"
    if world is not None and shards is None:
        raise SystemExit("under torchrun, pass --mesh-shards or --elastic "
                         "(the ranks serve one shard each)")
    if shards and shards != "auto":
        if shards & (shards - 1):
            raise SystemExit(f"--mesh-shards {shards} must be a power of "
                             "two (tournament merge)")
        if shards > n_dev:
            raise SystemExit(f"--mesh-shards {shards} > {n_dev} devices")
    return DiverseVectorDB(docs, "ip", shards=shards, num_lanes=args.lanes,
                           max_k=max(args.k, 16), M=8, policy=args.policy,
                           cache_size=args.cache_size, cost_model=cost_model,
                           prewarm=args.prewarm, elastic=args.elastic or None,
                           mesh=world, device=device or args.device)


def _torchrun_mesh(args):
    """The one-axis mesh over torchrun's ranks, and this rank's device."""
    import torch

    from repro_torch import resolve_device

    if args.backend is None:
        raise SystemExit("under torchrun, pass --backend nccl or gloo")
    world = int(os.environ["WORLD_SIZE"])
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = compat.make_process_mesh(
        (world,), ("data",), backend=args.backend,
        init_method=args.init_method, rank=int(os.environ["RANK"]),
        world_size=world, device=device)
    return mesh, device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--corpus", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=48)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--eps", type=float, default=3.0)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--engine", default="scheduler",
                    choices=["scheduler", "lockstep", "fixed_k"])
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "drr", "slo_cost"],
                    help="admission policy for the lane scheduler")
    ap.add_argument("--tenants", type=int, default=1,
                    help="label requests round-robin across N tenants "
                         "(per-tenant stats printed when N > 1)")
    ap.add_argument("--mesh-shards", type=int, default=0,
                    help="serve retrieval from a P-way sharded mesh backend "
                         "(0 = single-host engine)")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic mesh serving (shards='auto'): start on "
                         "half the available power-of-two devices and let "
                         "the scheduler grow/shrink the shard count under "
                         "sustained queue depth (requires --engine "
                         "scheduler; in-flight lanes migrate between "
                         "rounds, contract 16)")
    ap.add_argument("--cache-size", type=int, default=0,
                    help="semantic result cache capacity: repeated/near-"
                         "duplicate queries are served from certified "
                         "cached result sets after a Theorem-2 recheck "
                         "(0 = off; requires --engine scheduler)")
    ap.add_argument("--cost-model-path", default=None,
                    help="JSON file to warm-start the admission policies' "
                         "expansion cost model from (loaded if it exists) "
                         "and to persist the learned state back to after "
                         "the run")
    ap.add_argument("--upserts", type=int, default=0,
                    help="exercise the write path: N upserts before the "
                         "batch and N deletes after (requires --engine "
                         "scheduler); mutable-index stats are printed")
    ap.add_argument("--prewarm", action="store_true",
                    help="pre-compile the scheduler's capacity ladder")
    ap.add_argument("--device", default="cuda",
                    help="where the index, the engine and the model run")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the process group's backend under torchrun")
    ap.add_argument("--init-method", default="env://",
                    help="the process group's rendezvous under torchrun "
                         "(its env:// unless given)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    docs = rng.normal(size=(args.corpus, args.dim)).astype(np.float32)
    if (args.mesh_shards or args.elastic) and args.engine != "scheduler":
        raise SystemExit("--mesh-shards/--elastic require --engine "
                         "scheduler")
    if args.upserts and args.engine != "scheduler":
        raise SystemExit("--upserts requires --engine scheduler")
    world, device = None, args.device
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        world, device = _torchrun_mesh(args)
    if world is not None and world.rank != 0:
        # follow rank 0's facade until it closes; rank 0 serves
        _build_db(docs, args, None, world, device)
        _leave()
        return 0
    cfg = get_config(args.arch).reduced()
    params = M.init_params(cfg, 0, device=device)
    cost_model = None
    if args.cost_model_path and os.path.exists(args.cost_model_path):
        cost_model = ExpansionCostModel.load(args.cost_model_path)
        print(f"# cost model warm-started from {args.cost_model_path} "
              f"({cost_model.stats()['observations']} observations)")
    db = _build_db(docs, args, cost_model, world, device)
    pipe = RagPipeline(cfg, params, k=args.k, eps=args.eps,
                       engine=args.engine, num_lanes=args.lanes,
                       prewarm=args.prewarm, policy=args.policy,
                       cache_size=args.cache_size, cost_model=cost_model,
                       db=db)
    qs = docs[rng.integers(0, len(docs), args.requests)]
    if args.upserts:
        new_ids = db.upsert(rng.normal(size=(args.upserts, args.dim))
                            .astype(np.float32))
        print(f"# upserted {len(new_ids)} vectors "
              f"(ids {int(new_ids[0])}..{int(new_ids[-1])})")
    tenants = ([f"t{i % args.tenants}" for i in range(args.requests)]
               if args.tenants > 1 else None)
    if args.engine != "scheduler" and (tenants is not None
                                       or args.policy != "fifo"
                                       or args.cache_size
                                       or args.cost_model_path):
        # the lockstep/fixed_k paths never build a LaneScheduler, so these
        # flags would be silently ignored — refuse instead
        raise SystemExit("--tenants/--policy/--cache-size/--cost-model-path "
                         "require --engine scheduler")
    t0 = time.time()
    tokens, ids, cert = pipe.generate(qs, np.ones((args.requests, 2),
                                                  np.int32),
                                      steps=args.steps, tenants=tenants)
    dt = time.time() - t0
    print(f"{args.requests} requests in {dt:.2f}s; "
          f"certified={cert.tolist()}")
    print("retrieved ids:\n", ids)
    if args.upserts:
        victims = rng.integers(0, args.corpus, args.upserts)
        removed = db.delete(np.unique(victims))
        post = db.search(qs[0], k=args.k, eps=args.eps)
        idx = db.stats()["index"]
        print(f"# deleted {removed} ids; post-write search certified="
              f"{post.stats.certified} ids={post.ids.tolist()}")
        print(f"# index: n={idx['n_total']} live={idx['live']} "
              f"delta={idx['delta']} epoch={idx['epoch']} "
              f"rebuilds={idx['rebuilds']}")
    if args.engine == "scheduler":
        stats = pipe.scheduler.latency_stats()
        if args.elastic:
            where = (f"elastic-mesh[{stats['shards']}] "
                     f"scale_events={stats['scale_events']}")
        elif args.mesh_shards:
            where = f"mesh[{args.mesh_shards}]"
        else:
            where = "single-host"
        print(f"scheduler[{where}|{stats['policy']}]: "
              f"p50={stats['p50_latency'] * 1e3:.1f}ms "
              f"p99={stats['p99_latency'] * 1e3:.1f}ms "
              f"fairness={stats['fairness']:.3f} "
              f"throughput={stats['throughput']:.1f} req/s "
              f"signatures={stats['signatures']}")
        if tenants is not None:
            for name, t in stats["tenants"].items():
                print(f"  tenant[{name}]: completed={t['completed']} "
                      f"shed={t['shed']} deferred={t['deferred']} "
                      f"p50={t['p50_latency'] * 1e3:.1f}ms "
                      f"p99={t['p99_latency'] * 1e3:.1f}ms")
            print(f"  tenant_fairness={stats['tenant_fairness']:.3f} "
                  f"calibration_error={stats['cost_calibration_error']:.3f}")
        if args.cache_size:
            cs = stats["cache"]
            print(f"  cache[{args.cache_size}]: hits={stats['cache_hits']} "
                  f"hit_rate={stats['cache_hit_rate']:.3f} "
                  f"admitted={cs['admitted']} evicted={cs['evicted']} "
                  f"revalidation_failures={cs['revalidation_failures']}")
        if args.cost_model_path:
            pipe.scheduler.cost_model.save(args.cost_model_path)
            print(f"# cost model saved to {args.cost_model_path}")
    if world is not None:
        db.close()
        _leave()
    return 0


def _leave() -> None:
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
