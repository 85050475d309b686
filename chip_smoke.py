#!/usr/bin/env python3
"""Drive repro_torch's main path on one NVIDIA GPU and check its kernels.

Run from the root of a checkout, with no arguments, on a machine with one
CUDA card:

    python3 chip_smoke.py

Phases:
1. Device: fails unless ``torch.cuda.is_available()``; prints the card's
   name and power limit as nvidia-smi reports them.
2. Build: compiles every CUDA kernel under src/repro_torch/kernels/csrc
   with nvcc for sm_90a, one process per source, all at once.
3. Kernels against their plain versions, on the card, at the main path's
   shapes, for l2/ip/cos: the burst's gathered scoring (16 lanes x 32
   rows), the rebuild's corpus scoring (16 x n), and adjacency / greedy /
   fused round at W in {64, 256, 1024}, k = 10. The two similarity kernels
   must equal their plain versions bit for bit, and each other (a gathered
   score is the corpus score's column; one lane's corpus scores are its row
   of the batch's); the other integer outputs must be equal on inputs kept
   tie-free, and the fused round's certificate bit for bit. Times are CUDA
   events, median of 20 runs; the gathered scoring draws fresh random ids
   for every launch, so its rows come cold from device memory, as in the
   burst. The adjacency must also equal its own transpose. Each kernel's
   device time per call (``device_us``) is the duration of the kernels 20
   calls launched under torch.profiler, over the launches of the kernel
   itself that the profiler recorded with a duration, at least 10 of them
   (``device_us_kept``; the gathered scoring's: its launches in phase 4's
   profiled lockstep batch); ``host_us`` is the rest of the event time, the
   wrapper's host work.
4. The main path at Deep1M's shape: n = 1,000,000 seeded deep-like vectors
   of d = 96 (l2), a KNN graph with M = 16 built on the card, eps
   calibrated to an expected G^eps degree of 100. A ``ProgressiveEngine``
   of 16 lanes (k = 10, ef = 40, kernels "auto") is prewarmed and serves
   64 held-out PSS queries with continuous batching (admit, step, harvest,
   recycle), as the serving front door drives it. Every result must satisfy
   the diversity condition. The lockstep entry point ``batch_pss`` then
   serves the first 16 queries again on the kernels (and once more under
   ``torch.profiler``) and the first 8 on the plain versions: both must
   give the same ids and certificates as the engine.
5. The compressed-corpus path on phase 4's corpus, graph and first 16
   queries: the corpus quantized to int8 (8 rows per scale) and to PQ
   (16 subspaces of 6 dims, 256 centroids, 10 k-means iterations on a
   16 384-row sample), build times and bytes per vector; int8_dot and
   pq_lut_sum against their plain versions (l2/ip/cos at 16 x n, and at a
   ragged n = 100 003 with d = 30 and M = 5): integer dots and LUT sums,
   and so the quantized scores, must be equal bit for bit. Then the path
   itself: each scheme's ``quantized_similarity_many`` scores, a top-4k
   prefilter (score desc, id asc) and an exact float rerank give
   recall@5/@10 against the exact top-k (int8 held to 0.95); the first 4
   queries rerun on the plain versions must give the same prefilter and
   reranked ids; the queries' relative contrast (median over 10th-nearest
   distance) is recorded beside. Last, ``batch_beam_search`` (k = 10,
   L = 40) over phase 4's graph with each corpus (float, int8, PQ), its
   frontier reranked in float: recall@10 and steps. The float beam's
   first 4 queries rerun on the plain versions must give the same ids; its
   recall@10 is recorded at L = 40, 100, 200 from the graph's entry and at
   L = 40 from each query's true nearest node.

6. The sharded path on phase 4's corpus, queries and eps: (a) topk_merge
   against its plain version at 64 rows (4 shards x 16 lanes) and L in
   {10, 32, 128, 1000, 4096}, with equal scores, -0.0 beside +0.0 and
   padding tails: ids and score bits equal; timed at L = 32 and 4096. The
   tournament kernel (the whole butterfly in one launch) against the plain
   butterfly at 4 shards x 16 lanes and the same L, and at 8 shards and
   L = 4096 (its device-memory route), on runs that share ids across
   shards: ids and score bits equal; timed at L = 32 and 4096. The
   tournament is what the path launches, so its times fill the kernels
   line's topk_merge row (the two-run kernel's sit beside, "pairwise").
   (b) ``build_sharded_index``: 4 shards of 250 000 rows, M = 16, on the
   card, and an int8 copy of it (each shard quantized, 8 rows per scale).
   (c) ``sharded_topk`` (k = 10, L = 40) of 16 queries: tournament and
   allgather merges give equal ids, and so does a rerun on the plain
   versions; recall@10 against the exact top-10 is recorded. Then
   ``sharded_diverse_search`` (k = 10, K = 32, div-A*) on the float and the
   int8 index; every result must satisfy the diversity condition, and a
   rerun of each on the plain versions must give the same ids and
   certificates.
   (d) A prewarmed ``ShardedEngine`` (16 lanes, resume="beam", K0 = 32,
   L_factor = 4, 8 rounds, k = 10) serves the held-out queries with
   continuous admission. Every result must satisfy the diversity
   condition; every lane finished in its first round must equal
   ``sharded_diverse_search`` at its K_final; the first 8 queries rerun
   through ``sharded_progressive_diverse`` on the plain versions must give
   the same ids and certificates.

After phase 6: how many launches of pairwise_adjacency, fused_round and
greedy_diversify ran at each (lanes, width) in phases 4 and 6, read from the
engines' ``SignatureLog.counts`` (lanes as the log rounds them, to a power
of two), and the adjacency and the fused round timed again at their most
frequent shape (on phase 4's corpus), and greedy_diversify at 16 x 64, the
width it serves (prewarm, the sharded greedy diversify), with its k
dependent steps beside its bound. Phase 5 also times pq_lut_sum at one
query (the cos path's second call) and records beside its byte bound the
floor of its b * n * M shared-memory lookups at 32 a clock on each SM, at
the SM clock nvidia-smi reads under load. The ``ptxas -v`` summary
(registers, spills, shared memory) of the adjacency, the fused round,
greedy and the LUT sum is printed after the build.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json. Any failure exits non-zero before the last line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out")

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12      # H100 SXM float32 outside the tensor cores
PEAK_INT8_OP_S = 1979e12     # H100 SXM int8 tensor cores, dense
RTOL = ATOL = 1e-5
FRESH_IDS = 256   # pregenerated id sets: one per timed gathered launch
# the main path's configuration; only the data seed, the corpus size (the
# stated cut, if one is needed) and the query count are arguments
D, M_GRAPH, LANES, K, EF, PHI, RERUN = 96, 16, 16, 10, 40, 100.0, 8
# phase 5: the compressed-corpus path (benchmarks/batch_bench.py
# run_quantized's shape: a 4k prefilter, recall floor 0.95)
SCALE_ROWS, PQ_ITERS, PREFILTER, KS, BEAM_L, RERUN_Q = 8, 10, 4, (5, 10), 40, 4
BEAM_WIDER = (40, 100, 200)   # the float beam's recall against its width
INT8_RECALL_FLOOR = 0.95
RAGGED_N, RAGGED_D, RAGGED_M = 100_003, 30, 5
# the kernels each path must launch
PATH4_KERNELS = ("batch_similarity_many", "batch_similarity_gather",
                 "pairwise_adjacency", "greedy_diversify", "fused_round")
PATH5_KERNELS = ("int8_dot", "pq_lut_sum")
PATH6_KERNELS = ("topk_merge", "batch_similarity_gather", "pairwise_adjacency")
# phase 6: the sharded path (ShardedEngine's defaults)
SHARDS, SH_L, SH_KDIV, K0, L_FACTOR, MAX_ROUNDS = 4, 40, 32, 32, 4, 8
MERGE_ROWS, MERGE_LS, MERGE_TIMED = 64, (10, 32, 128, 1000, 4096), (32, 4096)
# the tournament at P = SHARDS: MERGE_LS and every L of phase 6's merges
# (k = 10, K = 32 and 64)
TOURNAMENT_LS = tuple(sorted({*MERGE_LS, 10, 32, 64}))
TOURNAMENT_DEVICE_ROUTE = (8, 4096)   # (P, L): 256 KB of runs a lane
# the engines' signature kinds that launch a kernel, one launch a signature
SIG_KERNELS = {"adjacency": "pairwise_adjacency", "fused_round": "fused_round",
               "greedy": "greedy_diversify", "sharded": "pairwise_adjacency"}
PTXAS_SOURCES = ("pairwise_adjacency", "fused_round", "greedy_diversify",
                 "pq_lut_sum")
# the path shapes timed at a fixed size: greedy at the prewarm's and the
# sharded diversify's width, the LUT sum at the cos path's second call
GREEDY_PATH_SHAPE = (16, 64)


T0 = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - T0:7.1f}s]", *a, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz(torch, fn, seconds: float = 1.0) -> float:
    """The SM clock nvidia-smi reads while ``fn()`` keeps the card busy:
    about ``seconds`` of launches are queued, then the clock is read before
    they drain."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t0, 1e-5)
    for _ in range(int(seconds / one) + 1):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    torch.cuda.synchronize()
    return float(out.stdout.strip().splitlines()[0])


def lookup_floor_ms(torch, lookups: int, mhz: float) -> float:
    """Least time for ``lookups`` 4-byte table reads from shared memory:
    32 banks a clock on each SM, free of bank conflicts."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return lookups / (32 * sms * mhz * 1e6) * 1e3


def bound_ms(bytes_moved: float, ops: float,
             peak_ops: float = PEAK_F32_FLOP_S) -> tuple[float, str]:
    tb, tf = bytes_moved / PEAK_BYTES_PER_S, ops / peak_ops
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def time_ms(torch, fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_us(torch, fn, primary: str, reps: int = 20
              ) -> tuple[float | None, dict[str, int], int]:
    """Device time per call of ``fn()`` in microseconds, from ``reps`` calls
    under torch.profiler after a warm-up: the summed duration of every
    kernel they launched over the launches of ``primary`` (the kernel named
    so launches once a call), counting only events the profiler recorded
    with a duration. After heavy device work the profiler drops some of a
    short session's events or keeps them with no duration, erratically; a
    session that kept fewer than reps / 2 timed launches of ``primary`` is
    run again, up to three in all, and the time is None if none did.
    Also the timed launches by kernel name, and how many of ``primary``
    were kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.device_time_total > 0]
        kept = sum(1 for e in kernels if primary in e.name)
        if 2 * kept >= reps:
            break
    names: dict[str, int] = {}
    for e in kernels:
        names[e.name[:80]] = names.get(e.name[:80], 0) + 1
    total = sum(e.device_time_total for e in kernels)
    return (total / kept if 2 * kept >= reps else None), names, kept


def host_us(ms: float, dev_us: float | None) -> float | None:
    """The part of a call's event time that is not its kernels' device
    time: the wrapper's host work and the launch, in microseconds."""
    return None if dev_us is None else ms * 1e3 - dev_us


def assert_bits_equal(torch, got, want, what: str) -> None:
    """Equal float32 bit patterns, or an AssertionError naming ``what``."""
    bad = got.contiguous().view(torch.int32) != want.contiguous().view(
        torch.int32)
    if got.shape != want.shape or bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} scores differ in their "
            f"bits (max {float((got - want).abs().max())})")


def deep_like(torch, n: int, d: int, seed: int, device):
    """The repo's deep-like mixture (64 Gaussian centres, noise 0.7), made
    on the card from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((64, d), generator=g, device=device)
    which = torch.randint(0, 64, (n,), generator=g, device=device)
    return (centers[which]
            + torch.randn((n, d), generator=g, device=device) * 0.7).contiguous()


# ------------------------------------------------------------- phase 3 ----

def tie_free_prefixes(torch, sim, x, B, W, metric, seed, device):
    """Sorted queue prefixes of B lanes at width W and per-lane eps at the
    0.9 quantile of candidate-pair similarity. A candidate with any pair
    within 1e-4 of its lane's eps is made a -1 sentinel, so no valid pair
    sits near a threshold."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = x.shape[0]
    ids = torch.randint(0, n, (B, W), generator=g, device=device,
                        dtype=torch.int32)
    scores = torch.sort(torch.randn((B, W), generator=g, device=device),
                        dim=1, descending=True).values
    rows = x[ids.long()]
    s = sim.pairwise_sim(rows, rows, metric)
    eps = torch.quantile(s.flatten(1)[:, :: max(1, W * W // 4096)], 0.9,
                         dim=1)
    near = ((s - eps[:, None, None]).abs() <= 1e-4)
    near &= ~torch.eye(W, dtype=torch.bool, device=device)
    bad = near.any(dim=2)
    ids = torch.where(bad, -1, ids)
    scores = torch.where(bad, float("-inf"), scores)
    # re-sort so sentinels sit where a queue keeps them: at the back
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    ids, scores = torch.gather(ids, 1, order), torch.gather(scores, 1, order)
    Ks = torch.randint(W // 2, W + 1, (B,), generator=g, device=device,
                       dtype=torch.int32)
    return ids.contiguous(), scores.contiguous(), Ks, eps.contiguous()


def check_kernels(torch, ops, sim, x, qs, seed, report):
    """Phase 3: every kernel against its plain version; returns timings."""
    device = x.device
    n, d = x.shape
    B, M, k = qs.shape[0], 2 * M_GRAPH, K
    nbrs = torch.randint(-1, n, (B, M), device=device, dtype=torch.int32,
                         generator=torch.Generator(device=device)
                         .manual_seed(seed + 1))
    errs: dict = {}
    for metric in ("l2", "ip", "cos"):
        e = {}
        got = ops.batch_similarity_gather(qs, x, nbrs, metric, impl="cuda")
        ref = ops.batch_similarity_gather(qs, x, nbrs, metric, impl="ref")
        assert_bits_equal(torch, got, ref, f"sim_gather ({metric})")
        e["batch_similarity_gather"] = float((got - ref).abs().max())
        many = ops.batch_similarity(qs, x, metric, impl="cuda")
        ref = ops.batch_similarity(qs, x, metric, impl="ref")
        assert_bits_equal(torch, many, ref, f"sim_many ({metric})")
        e["batch_similarity_many"] = float((many - ref).abs().max())
        # what the engine relies on: a pair scores the same bits in either
        # entry point, and a lane's scores do not depend on the batch
        assert_bits_equal(torch, got, torch.gather(
            many, 1, nbrs.clamp(min=0).long()),
            f"sim_gather against sim_many's columns ({metric})")
        for b in range(B):
            assert_bits_equal(torch, ops.batch_similarity(
                qs[b:b + 1], x, metric, impl="cuda")[0], many[b],
                f"sim_many of lane {b} alone ({metric})")
        del got, ref, many
        for W in (64, 256, 1024):
            ids, scores, Ks, eps = tie_free_prefixes(
                torch, sim, x, B, W, metric, seed + W, device)
            adj_k = ops.pairwise_adjacency_batch(x, ids, eps, metric,
                                                 impl="cuda")
            adj_r = ops.pairwise_adjacency_batch(x, ids, eps, metric,
                                                 impl="ref")
            if not torch.equal(adj_k, adj_r):
                raise AssertionError(f"adjacency differs ({metric}, W={W}): "
                                     f"{int((adj_k != adj_r).sum())} edges")
            if not torch.equal(adj_k, adj_k.transpose(1, 2)):
                raise AssertionError(f"adjacency not symmetric ({metric}, "
                                     f"W={W})")
            valid = ids >= 0
            gk = ops.greedy_diversify_batch(scores, adj_r, k, valid, impl="cuda")
            gr = ops.greedy_diversify_batch(scores, adj_r, k, valid, impl="ref")
            if not (torch.equal(gk[0], gr[0]) and torch.equal(gk[1], gr[1])):
                raise AssertionError(f"greedy differs ({metric}, W={W})")
            fk = ops.fused_round_batch(x, ids, scores, Ks, eps, k, metric,
                                       impl="cuda")
            fr = ops.fused_round_batch(x, ids, scores, Ks, eps, k, metric,
                                       impl="ref")
            for a, b in zip(fk, fr):
                if not torch.equal(a, b):
                    raise AssertionError(f"fused round differs ({metric}, W={W})")
            e[f"fused_round_W{W}"] = float(
                (fk[3] - fr[3]).abs().nan_to_num(0.0).max())
            e[f"edges_W{W}"] = int(adj_r.sum())
        errs[metric] = e
        log(f"kernels ok   {metric}: " + json.dumps(e))
    report["kernel_errors"] = errs

    # times at the main path's shapes, l2
    ids, scores, Ks, eps = tie_free_prefixes(torch, sim, x, B, 1024, "l2",
                                             seed + 7, device)
    adj = ops.pairwise_adjacency_batch(x, ids, eps, "l2", impl="ref")
    valid = ids >= 0
    W = ids.shape[1]
    picks_g = ops.greedy_diversify_batch(scores, adj, k, valid,
                                         impl="ref")[1].to(torch.int64)
    t = {}

    def row(name, fn_k, fn_p, fn_lib, nbytes, flops, replaces, source,
            max_err, primary):
        ms, pms = time_ms(torch, fn_k), time_ms(torch, fn_p, reps=5)
        lib = None if fn_lib is None else time_ms(torch, fn_lib)
        dev_us, names, kept = device_us(torch, fn_k, primary)
        bms, by = bound_ms(nbytes, flops)
        t[name] = dict(name=name, route="cuda", source=source,
                       replaces=replaces, ms=ms, plain_ms=pms, bound_ms=bms,
                       bound_by=by, library_ms=lib, max_abs_err=max_err,
                       device_us=dev_us, device_us_kept=kept,
                       host_us=host_us(ms, dev_us))
        report.setdefault("device_loops", {})[name] = dict(
            device_us=dev_us, kernels=names)
        log(f"time {name}: kernel {ms:.4f} ms (device {dev_us} us), "
            f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}), library {lib}")

    csrc = "src/repro_torch/kernels/csrc/"
    maxerr = {name: max(errs[m][name] for m in errs)
              for name in ("batch_similarity_many", "batch_similarity_gather")}
    row("batch_similarity_many",
        lambda: ops.batch_similarity(qs, x, "l2", impl="cuda"),
        lambda: ops.batch_similarity(qs, x, "l2", impl="ref"),
        lambda: torch.cdist(qs, x),
        4 * (n * d + B * d + B * n), 2 * B * n * d,
        "src/repro/kernels/batch_similarity.py:51",
        csrc + "batch_similarity.cu", maxerr["batch_similarity_many"],
        "sim_many_kernel")
    # fresh random ids for every timed launch: rows cold, as in the burst
    g = torch.Generator(device=device).manual_seed(seed + 2)
    fresh = iter([torch.randint(-1, n, (B, M), device=device,
                                dtype=torch.int32, generator=g)
                  for _ in range(FRESH_IDS)])
    row("batch_similarity_gather",
        lambda: ops.batch_similarity_gather(qs, x, next(fresh), "l2",
                                            impl="cuda"),
        lambda: ops.batch_similarity_gather(qs, x, next(fresh), "l2",
                                            impl="ref"),
        None, 4 * (B * M * d + B * d + 2 * B * M), 2 * B * M * d,
        "src/repro/kernels/batch_similarity.py:51",
        csrc + "batch_similarity.cu", maxerr["batch_similarity_gather"],
        "sim_gather_kernel")
    row("pairwise_adjacency",
        lambda: ops.pairwise_adjacency_batch(x, ids, eps, "l2", impl="cuda"),
        lambda: ops.pairwise_adjacency_batch(x, ids, eps, "l2", impl="ref"),
        None, *adjacency_work(ids, d),
        "src/repro/kernels/pairwise_adjacency.py:46",
        csrc + "pairwise_adjacency.cu", 0.0, "adjacency_kernel")
    row("greedy_diversify",
        lambda: ops.greedy_diversify_batch(scores, adj, k, valid, impl="cuda"),
        lambda: ops.greedy_diversify_batch(scores, adj, k, valid, impl="ref"),
        None, *greedy_work(scores, valid, picks_g, k),
        "src/repro/kernels/greedy_diversify.py:64",
        csrc + "greedy_diversify.cu", 0.0, "greedy_")
    # its floor is the chain of dependent steps, one a pick
    t["greedy_diversify"]["dependent_steps"] = k
    row("fused_round",
        lambda: ops.fused_round_batch(x, ids, scores, Ks, eps, k, "l2",
                                      impl="cuda"),
        lambda: ops.fused_round_batch(x, ids, scores, Ks, eps, k, "l2",
                                      impl="ref"),
        None, *fused_round_work(torch, ops, x, ids, scores, Ks, eps, k),
        "src/repro/kernels/fused_round.py:99",
        csrc + "fused_round.cu",
        max(errs[m][f"fused_round_W{w}"] for m in errs for w in (64, 256, 1024)),
        "fused_round_kernel")
    return t


def greedy_work(scores, valid, picks, k: int) -> tuple[int, int]:
    """Bytes and operations greedy needs on these lanes: the scores and the
    valid mask in, the picked rows of the adjacency, the picks out; one
    byte test a picked row's candidate."""
    B, W = scores.shape
    rows = int(picks.sum()) * W
    return 4 * B * W + B * W + rows + 4 * B * k, rows


def adjacency_work(ids, d: int) -> tuple[int, int]:
    """Bytes and flops the adjacency needs on these lanes: the valid rows,
    ids and eps in, G*W*W bools out; the sims of the valid pairs, one
    triangle (sim is symmetric), 2d flops each."""
    G, W = ids.shape
    nv = (ids >= 0).sum(1).long()
    pairs = int((nv * (nv - 1) // 2).sum())
    return 4 * (int(nv.sum()) * d + G * W + G) + G * W * W, 2 * pairs * d


def fused_round_work(torch, ops, x, ids, scores, Ks, eps,
                     k: int) -> tuple[int, int]:
    """Bytes and flops the fused round needs on these lanes: each lane's
    valid prefix (rows, ids, scores), Ks, eps and the outputs (sel_ids,
    selsc, count, cert); the sims of each pick against the lane's valid
    prefix."""
    B, W = ids.shape
    d = x.shape[1]
    col = torch.arange(W, device=ids.device)[None, :]
    npre = ((ids >= 0) & (col < Ks[:, None])).sum(1).long()
    picks = ops.fused_round_batch(x, ids, scores, Ks, eps, k, "l2",
                                  impl="ref")[2].long()
    return (4 * (int(npre.sum()) * (d + 2) + 2 * B + 2 * B * k + 3 * B),
            2 * int((picks * npre).sum()) * d)


# ------------------------------------------------------------- phase 4 ----

class StageTimer:
    """Wall time of the engine's stages, each closed by a device sync."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds: dict[str, float] = {}

    def wrap(self, module, attr, stage):
        fn = getattr(module, attr)
        torch = self.torch

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.seconds[stage] = self.seconds.get(stage, 0.0) + (
                time.perf_counter() - t0)
            return out

        setattr(module, attr, timed)


def profile_batch(torch, ops, run, batch_wall_s, what):
    """``run()`` again under torch.profiler: the device's busy share of its
    unprofiled wall time, kernels per burst step (one gathered-scoring
    launch a step), top kernels, and the gathered scoring's launches and
    device time by name. Device activity only: a host-op trace of ~100 ops
    per burst step takes minutes to parse."""
    from torch.profiler import ProfilerActivity, profile

    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    steps = ops.launch_counts()["batch_similarity_gather"]
    t0 = time.perf_counter()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"profile parsed in {time.perf_counter() - t0:.1f} s")
    busy_us = sum(e.device_time_total for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the gathered scoring's launches that the profiler kept with a duration
    gather = [e.device_time_total for e in kernels
              if "sim_gather" in e.name and e.device_time_total > 0]
    out = dict(device_kernels=len(kernels), burst_steps=steps,
               kernels_per_step=len(kernels) / max(steps, 1),
               device_busy_s=busy_us / 1e6, batch_wall_s=batch_wall_s,
               sim_gather_launches=len(gather),
               sim_gather_device_s=sum(gather) / 1e6,
               device_idle_share=(1.0 - busy_us / 1e6 / batch_wall_s
                                  if busy_us else None),
               top_kernels_s=[(name[:80], us / 1e6) for name, us in top])
    log(f"profile of {what}: " + json.dumps(out))
    return out


def serve(torch, engine, qs, request):
    """Continuous batching over the engine's lanes: a free lane takes the
    next query (``request(q)``), every occupied lane advances one round per
    step, finished lanes are harvested and recycled. Returns each query's
    result and its latency from admission to harvest."""
    pending = list(range(len(qs)))
    lane_query: dict[int, int] = {}
    admitted: dict[int, float] = {}
    results: list = [None] * len(qs)
    latency = [0.0] * len(qs)
    while pending or engine.active_count():
        for lane in engine.free_lanes():
            if not pending:
                break
            i = pending.pop(0)
            engine.admit(int(lane), request(qs[i]))
            lane_query[int(lane)] = i
            admitted[i] = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        now = time.perf_counter()
        for lane, res in engine.harvest():
            i = lane_query.pop(lane)
            results[i], latency[i] = res, now - admitted[i]
            engine.recycle(lane)
    return results, latency


def assert_results(torch, sim, x, ids, scores, eps, what):
    """Result ids [B, K] in range, finite scores, no duplicate, and no two
    returned ids G^eps neighbours (the kernels' arithmetic, sim.cuh's
    order, which dot_seq reproduces)."""
    n = x.shape[0]
    k = ids.shape[1]
    if bool(((ids < -1) | (ids >= n)).any()):
        raise AssertionError(f"{what}: ids out of range")
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"{what}: non-finite scores")
    valid = ids >= 0
    rows = x[ids.clamp(min=0).long()]
    pair = sim.query_sim(rows[:, :, None, :], rows[:, None, :, :], "l2")
    off = ~torch.eye(k, dtype=torch.bool, device=ids.device)
    bad = (pair > eps) & off & valid[:, :, None] & valid[:, None, :]
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} result pairs "
                             "violate sim < eps")
    dup = (ids[:, :, None] == ids[:, None, :]) & off & valid[:, :, None]
    if bool(dup.any()):
        raise AssertionError(f"{what}: duplicate ids in a result")


def main_path(torch, args, report, device):
    from repro_torch.core import batch_progressive as tbp
    from repro_torch.core.backend import LaneRequest
    from repro_torch.core import similarity as sim
    from repro_torch.index import flat
    from repro_torch.kernels import ops

    n, nq = args.n, args.queries
    allx = deep_like(torch, n + nq, D, args.seed, device)
    x_np = allx[:n].cpu().numpy()
    qs = allx[n:].cpu().numpy()
    build_timer = StageTimer(torch)
    for attr in ("_exact_knn", "_alpha_prune", "_add_reverse_edges",
                 "_stitch_components", "_directed_repair"):
        build_timer.wrap(flat, attr, attr.lstrip("_"))
    t0 = time.perf_counter()
    graph = flat.build_knn_graph(x_np, metric="l2", M=M_GRAPH, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"graph: n={n} d={D} M={M_GRAPH} built on the card in {build_s:.1f} s: "
        + json.dumps({k: round(v, 1) for k, v in build_timer.seconds.items()}))

    # eps at an expected G^eps degree of PHI: (n-1) * P(sim > eps)
    g = torch.Generator(device=device).manual_seed(args.seed + 1)
    m = 4096
    a = graph.vectors[torch.randint(0, n, (m,), generator=g, device=device)]
    b = graph.vectors[torch.randint(0, n, (m,), generator=g, device=device)]
    s = sim.pairwise_sim(a, b, "l2").flatten()
    rank = int(math.ceil((1.0 - PHI / (n - 1)) * s.numel()))
    eps = float(torch.kthvalue(s.cpu(), max(1, min(rank, s.numel()))).values)
    log(f"eps = {eps:.6f} (expected G^eps degree {PHI})")

    timer = StageTimer(torch)
    timer.wrap(tbp, "_batched_search_loop", "burst")
    timer.wrap(tbp, "_rebuild_lanes", "rebuild")
    timer.wrap(tbp, "_batched_adjacency", "adjacency")
    timer.wrap(tbp, "_batched_div_astar", "div_astar")
    timer.wrap(tbp.kops, "fused_round_batch", "fused_round")

    # the main path: prewarm the serving engine, then serve every query
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    engine = tbp.ProgressiveEngine(graph, num_lanes=LANES, max_k=K,
                                   default_ef=EF, kernel_impl="auto")
    engine.prewarm(max_capacity=1024, ks=(K,), widths=(64,))
    torch.cuda.synchronize()
    prewarm_s = time.perf_counter() - t0
    prewarm_launches = ops.launch_counts()
    timer.seconds.clear()
    t_all = time.perf_counter()
    results, lat = serve(torch, engine, qs,
                         lambda q: LaneRequest(q, K, eps, ef=EF))
    total_s = time.perf_counter() - t_all
    launches = ops.launch_counts()
    widths = launch_histogram(engine.signatures.counts, launches, "phase 4")
    stage_s = dict(timer.seconds)
    log("launches on the main path (prewarm + serving): "
        + json.dumps(launches) + "; of them in prewarm: "
        + json.dumps(prewarm_launches))
    missing = [k for k in PATH4_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    ids = torch.as_tensor(np.stack([r.ids for r in results]), device=device)
    cert = [bool(r.stats.certified) for r in results]
    if ids.shape != (nq, K):
        raise AssertionError(f"result shape {tuple(ids.shape)}")
    assert_results(torch, sim, graph.vectors, ids, torch.as_tensor(
        np.stack([r.scores for r in results])), eps, "PSS engine")

    # the lockstep entry point on the kernels, then on the plain versions:
    # the same ids and certificates as the continuously served lanes
    def same(res, first, what):
        got = np.stack([r.ids for r in results[:first]])
        got_cert = np.array(cert[:first])
        if not (np.array_equal(res.ids, got)
                and np.array_equal(res.stats.certified, got_cert)):
            raise AssertionError(f"{what} differs from the engine:\n{got}"
                                 f"\n{res.ids}")

    tl = time.perf_counter()
    lock = tbp.batch_pss(graph, qs[:LANES], K, eps, ef=EF, kernel_impl="auto")
    torch.cuda.synchronize()
    lockstep_s = time.perf_counter() - tl
    same(lock, LANES, "lockstep batch_pss")
    tr = time.perf_counter()
    ref = tbp.batch_pss(graph, qs[:RERUN], K, eps, ef=EF, kernel_impl="ref")
    rerun_s = time.perf_counter() - tr
    same(ref, RERUN, "plain-version rerun")
    profile = profile_batch(
        torch, ops, lambda: tbp.batch_pss(graph, qs[:LANES], K, eps, ef=EF,
                                          kernel_impl="auto"),
        lockstep_s, "the lockstep batch")
    lat_sorted = sorted(lat)
    summary = dict(
        n=n, d=D, M=M_GRAPH, k=K, ef=EF, lanes=LANES, queries=nq,
        eps=eps, phi=PHI, graph_build_s=build_s,
        graph_build_stage_s=build_timer.seconds, prewarm_s=prewarm_s,
        total_s=total_s, qps=nq / total_s, p50_s=lat_sorted[nq // 2],
        p99_s=lat_sorted[min(nq - 1, int(math.ceil(0.99 * nq)) - 1)],
        certified_share=sum(cert) / nq, stage_s=stage_s,
        launches=launches, prewarm_launches=prewarm_launches,
        lockstep_s=lockstep_s, lockstep_queries=LANES, widths=widths,
        rerun_ref_s=rerun_s, rerun_queries=RERUN, profile=profile,
        expansions=[int(r.stats.expansions) for r in results])
    report["main_path"] = summary
    log("main path: " + json.dumps({k: v for k, v in summary.items()
                                    if k != "expansions"}))
    return launches, graph, qs, eps


# ------------------------------------------------------------- phase 5 ----

def synced(torch, fn):
    """``fn()`` and its wall seconds, closed by a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_quantized_kernels(torch, quant, ops, corpora, qs, what):
    """int8_dot and pq_lut_sum against their plain versions on ``corpora``
    (int8, pq) for every metric, bit for bit, and the quantized scores of
    the two rungs with them. Returns the largest difference seen (0.0)."""
    from repro_torch.kernels.int8_similarity import int8_dot_cuda
    from repro_torch.kernels.pq_lut_similarity import pq_lut_sum_cuda
    from repro_torch.kernels.ref import int8_dot

    c8, pq = corpora
    qc, _ = quant.quantize_queries(qs)
    got, ref = int8_dot_cuda(qc, c8.codes), int8_dot(qc, c8.codes)
    if not torch.equal(got, ref):
        raise AssertionError(f"int8_dot differs ({what}): "
                             f"{int((got != ref).sum())} dots")
    err = {"int8_dot": float((got - ref).abs().max()), "pq_lut_sum": 0.0}
    for metric in ("l2", "ip", "cos"):
        T, S, _ = quant.pq_luts_many(qs, pq.codebooks, metric)
        for table in (T, S[None].contiguous()):
            got, ref = (pq_lut_sum_cuda(table, pq.codes),
                        quant.pq_lut_sum(table, pq.codes))
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"pq_lut_sum differs ({what}, {metric}): "
                    f"{int((got != ref).sum())} sums")
            err["pq_lut_sum"] = max(err["pq_lut_sum"],
                                    float((got - ref).abs().max()))
        for name, corpus in (("int8", c8), ("pq", pq)):
            got = ops.quantized_similarity_many(qs, corpus, metric, impl="cuda")
            ref = ops.quantized_similarity_many(qs, corpus, metric, impl="ref")
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"quantized scores differ ({what}, {name}, {metric}): "
                    f"max {float((got - ref).abs().max())}")
    log(f"quantized kernels ok ({what}): " + json.dumps(err))
    return err


def compressed_path(torch, report, graph, qs_np, seed, device):
    """Phase 5: the compressed-corpus path on phase 4's corpus and graph.
    Returns the two kernels' rows and every kernel's launches on the path."""
    from repro_torch import quant
    from repro_torch.core import batch as tbatch
    from repro_torch.core import beam_search as bs
    from repro_torch.core import similarity as sim
    from repro_torch.core.graph import make_flat_graph
    from repro_torch.index import flat
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_similarity import int8_dot_cuda
    from repro_torch.kernels.pq_lut_similarity import pq_lut_sum_cuda
    from repro_torch.kernels.ref import int8_dot

    x = graph.vectors
    n, d = x.shape
    qs = torch.as_tensor(qs_np, device=device)
    b = qs.shape[0]
    out: dict = {}

    # (b) the corpus builds and what they store
    c8, out["int8_build_s"] = synced(torch, lambda: quant.quantize_corpus(
        x, "int8", scale_rows=SCALE_ROWS))
    pq, out["pq_build_s"] = synced(torch, lambda: quant.quantize_corpus(
        x, "pq", pq_iters=PQ_ITERS, seed=seed))
    M, C = pq.codebooks.shape[:2]
    out["bytes_per_vector"] = {
        "float32": quant.corpus_bytes_per_vector(x),
        "int8": quant.corpus_bytes_per_vector(c8),
        "pq": quant.corpus_bytes_per_vector(pq)}
    out["int8_compression"] = (out["bytes_per_vector"]["float32"]
                               / out["bytes_per_vector"]["int8"])
    log(f"compressed corpora: int8 {out['int8_build_s']:.2f} s, PQ (M={M}, "
        f"C={C}) {out['pq_build_s']:.2f} s; bytes/vector "
        + json.dumps(out["bytes_per_vector"]))

    # (a) the kernels against their plain versions, at the path's shapes
    # and at a ragged one
    err = check_quantized_kernels(torch, quant, ops, (c8, pq), qs,
                                  f"{b} x {n}, d={d}")
    xr = deep_like(torch, RAGGED_N, RAGGED_D, seed + 200, device)
    qr = deep_like(torch, b, RAGGED_D, seed + 201, device)
    ragged = (quant.quantize_corpus(xr, "int8", scale_rows=SCALE_ROWS),
              quant.quantize_corpus(xr, "pq", pq_m=RAGGED_M, seed=seed))
    rerr = check_quantized_kernels(torch, quant, ops, ragged, qr,
                                   f"{b} x {RAGGED_N}, d={RAGGED_D}, "
                                   f"M={RAGGED_M}")
    del xr, qr, ragged

    qc, _ = quant.quantize_queries(qs)
    T, _, _ = quant.pq_luts_many(qs, pq.codebooks, "l2")
    lib = torch._int_mm(c8.codes, qc.t().contiguous())
    if not torch.equal(lib.t(), int8_dot(qc, c8.codes)):
        raise AssertionError("torch._int_mm disagrees with the exact dots")
    # the LUT sum as one library call: embedding_bag's sum over the rows
    # codes[n, m] + m * C of the tables laid out [M * C, b]
    bag_idx = (pq.codes.long()
               + torch.arange(M, device=device) * C).contiguous()
    bag_w = T.reshape(b, M * C).t().contiguous()
    bag = torch.nn.functional.embedding_bag
    lib = bag(bag_idx, bag_w, mode="sum")
    out["embedding_bag_max_abs_diff"] = float(
        (lib.t() - quant.pq_lut_sum(T, pq.codes)).abs().max())
    if not torch.allclose(lib.t(), quant.pq_lut_sum(T, pq.codes), rtol=RTOL,
                          atol=ATOL):
        raise AssertionError("embedding_bag disagrees with the LUT sums")
    del lib
    rows, whole = {}, {}
    csrc = "src/repro_torch/kernels/csrc/"
    for name, fn_k, fn_p, fn_lib, nbytes, nops, peak, replaces in (
            ("int8_dot", lambda: int8_dot_cuda(qc, c8.codes),
             lambda: int8_dot(qc, c8.codes),
             lambda: torch._int_mm(c8.codes, qc.t().contiguous()),
             n * d + b * d + 4 * b * n, 2 * b * n * d, PEAK_INT8_OP_S,
             "src/repro/kernels/int8_similarity.py:34"),
            ("pq_lut_sum", lambda: pq_lut_sum_cuda(T, pq.codes),
             lambda: quant.pq_lut_sum(T, pq.codes),
             lambda: bag(bag_idx, bag_w, mode="sum"),
             n * M + 4 * b * M * C + 4 * b * n, b * n * (M - 1),
             PEAK_F32_FLOP_S, "src/repro/kernels/pq_lut_similarity.py:47")):
        ms, pms = time_ms(torch, fn_k), time_ms(torch, fn_p, reps=5)
        lms = None if fn_lib is None else time_ms(torch, fn_lib)
        dev_us, _, kept = device_us(torch, fn_k, name + "_kernel")
        bms, by = bound_ms(nbytes, nops, peak)
        rows[name] = dict(name=name, route="cuda", source=csrc + name + ".cu",
                          replaces=replaces, ms=ms, plain_ms=pms,
                          bound_ms=bms, bound_by=by, library_ms=lms,
                          max_abs_err=max(err[name], rerr[name]),
                          device_us=dev_us, device_us_kept=kept,
                          host_us=host_us(ms, dev_us))
        log(f"time {name}: kernel {ms:.4f} ms (device {dev_us} us), "
            f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}), library {lms}")
    # the LUT sum's floor in shared memory: its b * n * M lookups at the SM
    # clock under load; and the cos path's second call, one table (the
    # centroid norms) over the same codes
    prow = rows["pq_lut_sum"]
    prow["sm_clock_mhz"] = sm_clock_mhz(
        torch, lambda: pq_lut_sum_cuda(T, pq.codes))
    prow["lookup_floor_ms"] = lookup_floor_ms(torch, b * n * M,
                                              prow["sm_clock_mhz"])
    S1 = quant.pq_luts_many(qs, pq.codebooks, "cos")[1][None].contiguous()
    assert_bits_equal(torch, pq_lut_sum_cuda(S1, pq.codes),
                      quant.pq_lut_sum(S1, pq.codes), "pq_lut_sum at 1 query")
    ms = time_ms(torch, lambda: pq_lut_sum_cuda(S1, pq.codes))
    pms = time_ms(torch, lambda: quant.pq_lut_sum(S1, pq.codes), reps=5)
    dev_us, _, kept = device_us(torch, lambda: pq_lut_sum_cuda(S1, pq.codes),
                                "pq_lut_sum_kernel")
    bms, by = bound_ms(n * M + 4 * M * C + 4 * n, n * (M - 1))
    prow["path_shape"] = dict(
        queries=1, rows=n, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        lookup_floor_ms=lookup_floor_ms(torch, n * M, prow["sm_clock_mhz"]),
        device_us=dev_us, device_us_kept=kept, host_us=host_us(ms, dev_us))
    log(f"time pq_lut_sum at 1 x {n} (the cos path's second call): kernel "
        f"{ms:.4f} ms (device {dev_us} us), plain {pms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}); lookup floor {prow['lookup_floor_ms']:.4f} ms "
        f"at 16 x n, SM clock {prow['sm_clock_mhz']} MHz")
    del S1
    for scheme, corpus in (("int8", c8), ("pq", pq)):
        whole[scheme] = time_ms(torch, lambda: ops.quantized_similarity_many(
            qs, corpus, "l2", impl="cuda"))
    out["quantized_similarity_many_ms"] = whole
    log("whole quantized_similarity_many (l2, 16 x n): "
        + json.dumps(whole) + " ms")
    del T, bag_idx, bag_w
    truth = {k: flat.exact_topk(qs, x, k, "l2", device=device)[0] for k in KS}
    # relative contrast of the queries: median l2 distance over the 10th
    # nearest's (near 1: neighbours barely closer than anything else)
    dist = 1.0 - sim.pairwise_sim(qs, x, "l2")
    out["relative_contrast"] = float(
        (dist.median(dim=1).values / dist.kthvalue(K, dim=1).values).mean())
    del dist
    log(f"relative contrast of the queries (median / {K}th-NN distance): "
        f"{out['relative_contrast']:.4f}")

    def recall(ids, k):
        return float(np.mean([len(set(ids[r, :k].tolist())
                                  & set(truth[k][r].tolist())) / k
                              for r in range(ids.shape[0])]))

    # (c) and (d), the path: counts from here on are the path's
    ops.reset_launch_counts()
    t_path = time.perf_counter()
    stv: dict = {}
    for scheme, corpus in (("int8", c8), ("pq", pq)):
        sims, score_s = synced(torch, lambda: ops.quantized_similarity_many(
            qs, corpus, "l2"))
        order = torch.sort(sims, dim=1, descending=True, stable=True).indices
        del sims
        plain = ops.quantized_similarity_many(qs[:RERUN_Q], corpus, "l2",
                                              impl="ref")
        order_p = torch.sort(plain, dim=1, descending=True,
                             stable=True).indices
        del plain
        res = {"score_s": score_s}
        for k in KS:
            pre = order[:, :PREFILTER * k]
            ids, _ = flat.exact_rerank(qs, pre, x, "l2", device=device)
            pre_p = order_p[:, :PREFILTER * k]
            ids_p, _ = flat.exact_rerank(qs[:RERUN_Q], pre_p, x, "l2",
                                         device=device)
            if not (torch.equal(pre_p, pre[:RERUN_Q])
                    and np.array_equal(ids_p, ids[:RERUN_Q])):
                raise AssertionError(f"{scheme} k={k}: the plain-version "
                                     "rerun gives other ids")
            res[f"recall@{k}"] = recall(ids, k)
            if scheme == "int8" and res[f"recall@{k}"] < INT8_RECALL_FLOOR:
                raise AssertionError(
                    f"int8 recall@{k} {res[f'recall@{k}']:.3f} under the "
                    f"floor {INT8_RECALL_FLOOR}")
        stv[scheme] = res
        log(f"score-then-verify {scheme}: " + json.dumps(res))
    beam: dict = {}
    beam_ids: dict = {}
    for scheme, corpus in (("float", x), ("int8", c8), ("pq", pq)):
        g = make_flat_graph(corpus, graph.neighbors, None, graph.entry, "l2",
                            device=device)
        st, beam_s = synced(torch, lambda: bs.run_search(
            g, qs, bs.init_state(g, qs, BEAM_L), stable_limit=BEAM_L))
        ids_k, _ = tbatch.batch_beam_search(g, qs, K, BEAM_L)
        if not torch.equal(ids_k, st.queue.ids[:, :K]):
            raise AssertionError(f"batch_beam_search differs from its loop "
                                 f"({scheme})")
        beam_ids[scheme] = ids_k
        ids, _ = flat.exact_rerank(qs, st.queue.ids, x, "l2", device=device)
        steps = st.steps.cpu().numpy()
        beam[scheme] = {"recall@10": recall(ids, K),
                        "recall@10_before_rerank": recall(
                            ids_k.cpu().numpy(), K),
                        "steps_mean": float(steps.mean()),
                        "steps_max": int(steps.max()), "search_s": beam_s}
        log(f"batch_beam_search {scheme}: " + json.dumps(beam[scheme]))
    launches = ops.launch_counts()
    missing = [k for k in PATH5_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the compressed path: "
                             f"{missing}")
    out.update(score_then_verify=stv, beam_search=beam,
               path_s=time.perf_counter() - t_path,
               launches={k: launches[k] for k in PATH5_KERNELS})

    # after the path's counts: the float beam rerun on the plain versions,
    # and where its recall comes from (a wider beam, the true nearest node
    # as the entry)
    gf = make_flat_graph(x, graph.neighbors, None, graph.entry, "l2",
                         device=device)
    ids_p, _ = tbatch.batch_beam_search(gf, qs[:RERUN_Q], K, BEAM_L,
                                        impl="ref")
    if not torch.equal(ids_p, beam_ids["float"][:RERUN_Q]):
        raise AssertionError("float beam search: the plain-version rerun "
                             "gives other ids")
    nearest = torch.as_tensor(truth[K][:, 0], dtype=torch.int32,
                              device=device)
    reach = {}
    for L, start in [(L, "entry") for L in BEAM_WIDER] + [(BEAM_L,
                                                          "nearest")]:
        st = bs.init_state(gf, qs, L)
        if start == "nearest":
            st.queue.ids[:, 0] = nearest
            st.queue.scores[:, 0] = ops.batch_similarity_gather(
                qs, x, nearest[:, None], "l2")[:, 0]
        st = bs.run_search(gf, qs, st, stable_limit=L)
        steps = st.steps.cpu().numpy()
        reach[f"L{L}_{start}"] = {"recall@10": recall(
            st.queue.ids[:, :K].cpu().numpy(), K),
            "steps_mean": float(steps.mean())}
    out["float_beam_reach"] = reach
    log("float beam: plain rerun of 4 queries gives the same ids; recall@10 "
        "by beam width and entry " + json.dumps(reach))
    report["compressed_path"] = out
    log("compressed path: launches " + json.dumps(out["launches"]))
    return rows, launches


# ------------------------------------------------------------- phase 6 ----

def merge_runs(torch, R, L, seed, device):
    """Two runs a row, [R, L] each, sorted by (score desc, id asc): ids
    drawn per row from [0, 4L) (the runs share ids, so equal keys meet
    across runs), scores from nine values with about a third zeros, half of
    those -0.0, and a (-1, -inf) padding tail of random length; row 0 of
    the second run is all padding."""
    rng = np.random.default_rng(seed)
    out = []
    for run in range(2):
        ids = np.argsort(rng.random((R, 4 * L)), axis=1)[:, :L].astype(np.int32)
        sc = (rng.integers(-4, 5, (R, L)) * 0.5).astype(np.float32)
        sc[rng.random((R, L)) < 0.3] = 0.0
        sc[rng.random((R, L)) < 0.5] *= -1.0
        npad = rng.integers(0, L // 4 + 1, R)
        if run == 1:
            npad[0] = L
        for r in range(R):
            order = np.lexsort((ids[r], -sc[r]))
            ids[r], sc[r] = ids[r][order], sc[r][order]
            ids[r, L - npad[r]:] = -1
            sc[r, L - npad[r]:] = -np.inf
        out += [torch.from_numpy(ids).to(device),
                torch.from_numpy(sc).to(device)]
    return out


def tournament_runs(torch, P, B, L, seed, device):
    """The shards' runs [P, B, L]: shard p is run p % 2 of ``merge_runs``
    drawn with its own seed (so shards share ids, and lane 0 of every odd
    shard is all padding); lane B - 1 of shard 1 repeats shard 0's with its
    zeros' signs flipped (ties on both keys, other bits)."""
    runs = [merge_runs(torch, B, L, seed + 7 * p, device)[2 * (p % 2):][:2]
            for p in range(P)]
    ids = torch.stack([r[0] for r in runs])
    sc = torch.stack([r[1] for r in runs])
    ids[1, -1] = ids[0, -1]
    sc[1, -1] = torch.where(sc[0, -1] == 0.0, -sc[0, -1], sc[0, -1])
    return ids, sc


def check_topk_merge(torch, device, seed):
    """Phase 6 (a): the two-run topk_merge and the tournament against their
    plain versions, ids and score bits; returns the kernels-line row (the
    tournament, which the path launches, timed at L = 32, the path's first
    rung) and the times at each timed L of both."""
    from repro_torch.kernels.ref import topk_merge as plain
    from repro_torch.kernels.ref import topk_tournament as plain_tournament
    from repro_torch.kernels.topk_merge import (topk_merge_cuda,
                                                topk_tournament_cuda)

    def same(got, want, what):
        (gi, gs), (ri, rs) = got, want
        if not (torch.equal(gi, ri)
                and torch.equal(gs.view(torch.int32), rs.view(torch.int32))):
            raise AssertionError(
                f"{what} differs: {int((gi != ri).sum())} ids, "
                f"{int((gs.view(torch.int32) != rs.view(torch.int32)).sum())}"
                " score bit patterns")

    def timed(fn, fn_plain, primary, nbytes, ops):
        ms = time_ms(torch, fn)
        pms = time_ms(torch, fn_plain, reps=5)
        dev_us, _, kept = device_us(torch, fn, primary)
        bms, by = bound_ms(nbytes, ops)
        return dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                    device_us=dev_us, device_us_kept=kept,
                    host_us=host_us(ms, dev_us))

    R = MERGE_ROWS
    times, tour = {}, {}
    for L in MERGE_LS:
        args = merge_runs(torch, R, L, seed + L, device)
        same(topk_merge_cuda(*args), plain(*args), f"topk_merge at L={L}")
        if L in MERGE_TIMED:
            # bytes: two runs read, one written; operations: each entry's
            # binary search, ~log2(L) + 1 comparisons of two keys
            times[L] = timed(lambda: topk_merge_cuda(*args),
                             lambda: plain(*args), "topk_merge_kernel",
                             24 * R * L, 2 * R * L * 2 * (math.log2(L) + 1))
            log(f"time topk_merge {R} x {L}: " + json.dumps(times[L]))
    B = R // SHARDS
    for P, L in ([(SHARDS, L) for L in TOURNAMENT_LS]
                 + [TOURNAMENT_DEVICE_ROUTE]):
        ids, sc = tournament_runs(torch, P, B, L, seed + 50 + L, device)
        same(topk_tournament_cuda(ids, sc), plain_tournament(ids, sc),
             f"topk_tournament at P={P}, L={L}")
        if P == SHARDS and L in MERGE_TIMED:
            # bytes: P runs read, one written; operations: each entry's
            # P - 1 binary searches of ~log2(L) + 1 steps, two comparisons
            # each, at most (a search stops once the rank reaches L): the
            # bytes bound it even at that most
            tour[L] = timed(lambda: topk_tournament_cuda(ids, sc),
                            lambda: plain_tournament(ids, sc),
                            "topk_tournament_kernel", 8 * B * L * (P + 1),
                            B * P * L * (P - 1) * (math.log2(L) + 1) * 2)
            log(f"time topk_tournament {P} x {B} x {L}: "
                + json.dumps(tour[L]))
    log(f"topk_merge ok: {R} rows at L in {MERGE_LS}; the tournament at "
        f"{SHARDS} x {B} at L in {TOURNAMENT_LS} and at P, L = "
        f"{TOURNAMENT_DEVICE_ROUTE}: ids and score bits equal")
    row = dict(name="topk_merge", route="cuda",
               source="src/repro_torch/kernels/csrc/topk_merge.cu",
               replaces="src/repro/kernels/topk_merge.py:53",
               library_ms=None, max_abs_err=0.0, **tour[MERGE_TIMED[0]],
               shape=f"tournament {SHARDS} x {B} x {MERGE_TIMED[0]}",
               pairwise=dict(times[MERGE_TIMED[0]],
                             shape=f"{R} x {MERGE_TIMED[0]}"))
    return row, {"pairwise": times, "tournament": tour}


def sharded_path(torch, report, graph, qs_np, eps, seed, device):
    """Phase 6: the sharded path on phase 4's corpus, queries and eps.
    Returns topk_merge's row and the path's launches of every kernel."""
    import dataclasses

    from repro_torch import quant
    from repro_torch import sharded_search as ss
    from repro_torch.compat import make_mesh
    from repro_torch.core import similarity as sim
    from repro_torch.core.backend import LaneRequest
    from repro_torch.index import flat
    from repro_torch.kernels import ops
    from repro_torch.sharded_search import search as ssearch

    out: dict = {}
    row, out["topk_merge_times"] = check_topk_merge(torch, device, seed)

    # (b) set-up: the shard graphs on the card, and an int8 copy
    x = graph.vectors
    x_np = x.cpu().numpy()
    n = x.shape[0]
    build_timer = StageTimer(torch)
    for attr in ("_exact_knn", "_alpha_prune", "_add_reverse_edges",
                 "_stitch_components", "_directed_repair"):
        build_timer.wrap(flat, attr, attr.lstrip("_"))
    index, out["build_s"] = synced(torch, lambda: ss.build_sharded_index(
        x_np, SHARDS, "l2", M=M_GRAPH, device=device))
    out["build_stage_s"] = build_timer.seconds
    c8 = [quant.quantize_int8(index.vectors[s], scale_rows=SCALE_ROWS)
          for s in range(SHARDS)]
    index8 = dataclasses.replace(
        index, vectors=None, codes=torch.stack([c.codes for c in c8]),
        scales=torch.stack([c.scales for c in c8]), scheme="int8",
        scale_rows=SCALE_ROWS)
    del c8
    log(f"sharded index: {SHARDS} shards of {index.shard_size} rows, "
        f"M={M_GRAPH}, built on the card in {out['build_s']:.1f} s: "
        + json.dumps({k: round(v, 1) for k, v in build_timer.seconds.items()}))
    mesh = make_mesh((SHARDS,), ("data",), device=device)

    # (c) the scratch half; counts from here on are the path's
    q16 = torch.as_tensor(qs_np[:LANES], device=device)
    ops.reset_launch_counts()
    t_path = time.perf_counter()
    (ids_t, _), out["topk_s"] = synced(torch, lambda: ss.sharded_topk(
        index, q16, K, SH_L, mesh))
    ids_a, _ = ss.sharded_topk(index, q16, K, SH_L, mesh, merge="allgather")
    if not torch.equal(ids_t, ids_a):
        raise AssertionError("sharded_topk: tournament and allgather merges "
                             "give other ids")
    ops.set_default_impl("ref")
    try:
        ids_p, _ = ss.sharded_topk(index, q16, K, SH_L, mesh)
    finally:
        ops.set_default_impl(None)
    if not torch.equal(ids_t, ids_p):
        raise AssertionError("sharded_topk: the plain-version rerun gives "
                             "other ids")
    truth = flat.exact_topk(q16, x, K, "l2", device=device)[0]
    got = ids_t.cpu().numpy()
    out["topk_recall@10"] = float(np.mean(
        [len(set(got[r].tolist()) & set(truth[r].tolist())) / K
         for r in range(len(got))]))
    log(f"sharded_topk k={K} L={SH_L}: tournament == allgather == plain "
        f"rerun; recall@10 {out['topk_recall@10']:.4f}")
    for name, idx, xs in (("float", index, x), ("int8", index8, x_np)):
        (d_ids, d_sc, d_cert), secs = synced(
            torch, lambda: ss.sharded_diverse_search(idx, xs, q16, K, eps,
                                                     SH_KDIV, mesh))
        assert_results(torch, sim, x, d_ids, d_sc, eps,
                       f"sharded_diverse_search {name}")
        ops.set_default_impl("ref")
        try:
            p_ids, _, p_cert = ss.sharded_diverse_search(idx, xs, q16, K, eps,
                                                         SH_KDIV, mesh)
        finally:
            ops.set_default_impl(None)
        if not (torch.equal(p_ids, d_ids) and torch.equal(p_cert, d_cert)):
            raise AssertionError(f"sharded_diverse_search {name}: the "
                                 "plain-version rerun differs")
        out[f"diverse_{name}"] = dict(
            seconds=secs, certified_share=float(d_cert.float().mean()))
        log(f"sharded_diverse_search {name} (k={K}, K={SH_KDIV}; the plain "
            "rerun gives the same ids and certificates): "
            + json.dumps(out[f"diverse_{name}"]))

    # (d) the engine, serving with continuous admission
    timer = StageTimer(torch)
    for attr, stage in (("_resume_beams", "beams"), ("_merge", "merge"),
                        ("_adjacency", "adjacency"),
                        ("_div_astar", "div_astar")):
        timer.wrap(ssearch, attr, stage)
    t0 = time.perf_counter()
    eng = ss.ShardedEngine(index, x, mesh, num_lanes=LANES, K0=K0,
                           L_factor=L_FACTOR, max_rounds=MAX_ROUNDS, max_k=K,
                           resume="beam")
    eng.prewarm()
    torch.cuda.synchronize()
    out["prewarm_s"] = time.perf_counter() - t0
    timer.seconds.clear()
    nq = len(qs_np)
    t_all = time.perf_counter()
    def request(q):
        return LaneRequest(q, K, eps, method="sharded")

    results, lat = serve(torch, eng, qs_np, request)
    total_s = time.perf_counter() - t_all
    launches = ops.launch_counts()
    # the engine's own launches; (c)'s two scratch searches launched the
    # adjacency too, outside its log
    out["widths"] = launch_histogram(eng.signatures.counts, launches,
                                     "phase 6 (d)")
    stage_s = dict(timer.seconds)
    out["path_s"] = time.perf_counter() - t_path
    missing = [k for k in PATH6_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the sharded path: "
                             f"{missing}")
    ids = torch.as_tensor(np.stack([r.ids for r in results]), device=device)
    assert_results(torch, sim, x, ids, torch.as_tensor(
        np.stack([r.scores for r in results])), eps, "ShardedEngine")
    cert = np.array([r.stats.certified for r in results])
    K_final = np.array([r.stats.K_final for r in results])
    # a lane finished in its first round is the scratch computation
    single = [i for i, r in enumerate(results) if r.stats.search_calls == 1]
    for Kf in sorted(set(K_final[single].tolist())):
        group = [i for i in single if K_final[i] == Kf]
        s_ids, _, s_cert = ss.sharded_diverse_search(
            index, x, qs_np[group], K, eps, int(Kf), mesh)
        if not (np.array_equal(s_ids.cpu().numpy(), ids[group].cpu().numpy())
                and np.array_equal(s_cert.cpu().numpy(), cert[group])):
            raise AssertionError(f"single-round lanes at K={Kf} differ from "
                                 "sharded_diverse_search")
    ops.set_default_impl("ref")
    try:
        (p_ids, _, p_cert, _), rerun_s = synced(
            torch, lambda: ss.sharded_progressive_diverse(
                index, x, qs_np[:RERUN], K, eps, mesh, K0=K0,
                L_factor=L_FACTOR, max_rounds=MAX_ROUNDS, resume="beam"))
    finally:
        ops.set_default_impl(None)
    if not (np.array_equal(p_ids, ids[:RERUN].cpu().numpy())
            and np.array_equal(p_cert, cert[:RERUN])):
        raise AssertionError("sharded_progressive_diverse on the plain "
                             "versions differs from the engine")
    # the device's share: the first 16 queries served again, then once
    # more under the profiler
    _, wall16 = synced(torch, lambda: serve(torch, eng, qs_np[:LANES],
                                            request))
    out["profile"] = profile_batch(
        torch, ops, lambda: serve(torch, eng, qs_np[:LANES], request),
        wall16, f"the engine serving {LANES} queries")
    lat_sorted = sorted(lat)
    out.update(
        n=n, shards=SHARDS, shard_size=index.shard_size, k=K, lanes=LANES,
        K0=K0, L_factor=L_FACTOR, max_rounds=MAX_ROUNDS, queries=nq,
        total_s=total_s, qps=nq / total_s, p50_s=lat_sorted[nq // 2],
        p99_s=lat_sorted[min(nq - 1, int(math.ceil(0.99 * nq)) - 1)],
        certified_share=float(cert.mean()),
        K_final_hist={int(v): int(c) for v, c in
                      zip(*np.unique(K_final, return_counts=True))},
        rounds_hist={int(v): int(c) for v, c in zip(*np.unique(
            [r.stats.search_calls for r in results], return_counts=True))},
        expansions=[int(r.stats.expansions) for r in results],
        stage_s=stage_s, single_round_lanes=len(single),
        dispatches=sum(eng.signatures.counts.values()),
        rerun_ref_s=rerun_s, rerun_queries=RERUN,
        launches={k: launches[k] for k in PATH6_KERNELS})
    report["sharded_path"] = out
    log("sharded path: " + json.dumps({k: v for k, v in out.items()
                                       if k != "expansions"}))
    return row, launches


def launch_histogram(counts: dict, launches: dict, what: str) -> dict:
    """{kernel: {"lanes x width": launches}} from an engine's
    ``SignatureLog.counts``: each signature of a kind in SIG_KERNELS is one
    launch of its kernel at (lanes, width), lanes as the log rounds them.
    Logged beside the window's launch counters."""
    hist: dict = {}
    for sig, n in counts.items():
        name = SIG_KERNELS.get(sig[0])
        if name is not None:
            key = f"{sig[1]} x {sig[2]}"
            by = hist.setdefault(name, {})
            by[key] = by.get(key, 0) + n
    hist = {name: dict(sorted(by.items(), key=lambda kv: -kv[1]))
            for name, by in hist.items()}
    log(f"launches by (lanes x width), {what}: " + json.dumps(hist)
        + "; the window's counters: " + json.dumps(
            {name: launches[name] for name in hist}))
    return hist


def most_frequent_shape(hists: list[dict], name: str) -> tuple[int, int]:
    """(lanes, width) of the most launches of kernel ``name`` over the
    histograms (ties: the wider)."""
    total: dict = {}
    for h in hists:
        for key, n in h.get(name, {}).items():
            total[key] = total.get(key, 0) + n
    key = max(total, key=lambda kv: (total[kv], int(kv.split(" x ")[1])))
    lanes, width = key.split(" x ")
    return int(lanes), int(width)


def time_at_path_shapes(torch, ops, sim, x, hists, seed, timings) -> dict:
    """The adjacency and the fused round timed at their most frequent
    (lanes, width) on the main path, and greedy at GREEDY_PATH_SHAPE, l2,
    on tie-free prefixes over ``x``; each result also goes into its
    kernels-line row as ``path_shape``."""
    out = {}
    for name, primary in (("pairwise_adjacency", "adjacency_kernel"),
                          ("fused_round", "fused_round_kernel")):
        lanes, W = most_frequent_shape(hists, name)
        ids, scores, Ks, eps = tie_free_prefixes(torch, sim, x, lanes, W,
                                                 "l2", seed + W, x.device)
        if name == "pairwise_adjacency":
            fn_k = lambda: ops.pairwise_adjacency_batch(x, ids, eps, "l2",
                                                        impl="cuda")
            fn_p = lambda: ops.pairwise_adjacency_batch(x, ids, eps, "l2",
                                                        impl="ref")
            work = adjacency_work(ids, x.shape[1])
        else:
            fn_k = lambda: ops.fused_round_batch(x, ids, scores, Ks, eps, K,
                                                 "l2", impl="cuda")
            fn_p = lambda: ops.fused_round_batch(x, ids, scores, Ks, eps, K,
                                                 "l2", impl="ref")
            work = fused_round_work(torch, ops, x, ids, scores, Ks, eps, K)
        got, want = fn_k(), fn_p()
        if name == "pairwise_adjacency":
            same = torch.equal(got, want)
        else:
            same = all(torch.equal(a, b) for a, b in zip(got, want))
        if not same:
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{lanes} x {W}")
        ms, pms = time_ms(torch, fn_k), time_ms(torch, fn_p, reps=5)
        dev_us, _, kept = device_us(torch, fn_k, primary)
        bms, by = bound_ms(*work)
        out[name] = dict(lanes=lanes, width=W, ms=ms, plain_ms=pms,
                         bound_ms=bms, bound_by=by, device_us=dev_us,
                         device_us_kept=kept, host_us=host_us(ms, dev_us))
        timings[name]["path_shape"] = out[name]
        log(f"time {name} at the path's most frequent shape {lanes} x {W}: "
            f"kernel {ms:.4f} ms (device {dev_us} us), plain {pms:.4f} ms, "
            f"bound {bms:.6f} ms ({by})")
    # greedy at the width it serves: the prewarm's and the sharded
    # diversify's (phase 6 runs div-A*, so none of its launches is there)
    lanes, W = GREEDY_PATH_SHAPE
    ids, scores, _, eps = tie_free_prefixes(torch, sim, x, lanes, W, "l2",
                                            seed + W, x.device)
    adj = ops.pairwise_adjacency_batch(x, ids, eps, "l2", impl="ref")
    valid = ids >= 0
    fn_k = lambda: ops.greedy_diversify_batch(scores, adj, K, valid,
                                              impl="cuda")
    fn_p = lambda: ops.greedy_diversify_batch(scores, adj, K, valid,
                                              impl="ref")
    got, want = fn_k(), fn_p()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"greedy_diversify differs from its plain "
                             f"version at {lanes} x {W}")
    ms, pms = time_ms(torch, fn_k), time_ms(torch, fn_p, reps=5)
    dev_us, _, kept = device_us(torch, fn_k, "greedy_")
    bms, by = bound_ms(*greedy_work(scores, valid, want[1].long(), K))
    out["greedy_diversify"] = dict(
        lanes=lanes, width=W, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        dependent_steps=K, device_us=dev_us, device_us_kept=kept,
        host_us=host_us(ms, dev_us))
    timings["greedy_diversify"]["path_shape"] = out["greedy_diversify"]
    log(f"time greedy_diversify at {lanes} x {W}: kernel {ms:.4f} ms (device "
        f"{dev_us} us), plain {pms:.4f} ms, bound {bms:.6f} ms ({by})")
    return out


def ptxas_summary(logs: dict) -> dict:
    """Registers, spills and shared memory of each kernel in the ptxas -v
    output of PTXAS_SOURCES: the lines that name them, by source."""
    keep = ("Compiling entry", "registers", "spill", "smem")
    return {name: [line.strip() for line in logs.get(name, "").splitlines()
                   if any(word in line for word in keep)]
            for name in PTXAS_SOURCES}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--queries", type=int, default=64)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core import similarity as sim
    from repro_torch.kernels import _build, ops

    os.makedirs(OUT, exist_ok=True)
    report: dict = {"argv": sys.argv[1:]}
    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    report["nvidia_smi"] = smi

    t0 = time.perf_counter()
    per_source = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.1f} s wall, per source "
        + json.dumps({k: round(v, 1) for k, v in per_source.items()}))
    logs = {name: _build.ptxas_log(name) for name in _build.SOURCES}
    with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
        for name, text in logs.items():
            f.write(f"=== {name}\n{text}\n")
    report["build_s"] = build_s
    report["ptxas"] = ptxas_summary(logs)
    for name, lines in report["ptxas"].items():
        log(f"ptxas {name}.cu:\n  " + "\n  ".join(lines))

    device = torch.device("cuda")
    x = deep_like(torch, args.n, D, args.seed + 100, device)
    qs = deep_like(torch, LANES, D, args.seed + 101, device)
    timings = check_kernels(torch, ops, sim, x, qs, args.seed, report)
    del x
    torch.cuda.empty_cache()

    launches, graph, qs_np, eps = main_path(torch, args, report, device)
    qrows, qlaunches = compressed_path(torch, report, graph, qs_np[:LANES],
                                       args.seed, device)
    timings.update(qrows)
    mrow, slaunches = sharded_path(torch, report, graph, qs_np, eps,
                                   args.seed, device)
    timings["topk_merge"] = mrow
    hists = [report["main_path"]["widths"], report["sharded_path"]["widths"]]
    report["path_shape_times"] = time_at_path_shapes(
        torch, ops, sim, graph.vectors, hists, args.seed + 300, timings)
    # the gathered scoring's device time per launch as the burst meets it:
    # its launches in phase 4's profiled lockstep batch
    prof = report["main_path"]["profile"]
    row = timings["batch_similarity_gather"]
    row["device_us_fresh_ids"] = row["device_us"]
    row["device_us"] = (prof["sim_gather_device_s"] * 1e6
                        / prof["sim_gather_launches"]
                        if prof["sim_gather_launches"] else None)
    row["device_us_kept"] = prof["sim_gather_launches"]
    # each kernel's launches over the three paths' runs (each path's own
    # counts are in chip_smoke.json)
    kernels = []
    for name, row in timings.items():
        total = launches[name] + qlaunches[name] + slaunches[name]
        kernels.append(dict(row, launches=int(total)))
    report["kernels"] = kernels
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
