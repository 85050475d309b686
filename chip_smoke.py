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
   (b) ``DiverseVectorDB(x, "l2", shards=4, M=16, num_lanes=16,
   max_k=10, default_ef=40, cache_size=64, delta_capacity=256)`` (the
   engine's knobs as (d)'s) builds the index through the facade
   (``build_sharded_index``: 4 shards of 250 000 rows, on the card); phase
   6 takes ``db.index.sharded``; then an int8 copy of it (each shard
   quantized, 8 rows per scale).
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

7. The serving front door on phase 4's graph, eps and queries:
   ``DiverseVectorDB(index=graph, num_lanes=16, max_k=10, default_ef=40,
   cache_size=64, delta_capacity=256)``, prewarmed as phase 4's engine.
   (a) ``search_batch`` of the 64 queries: each result (ids, score bits,
   certificate, K_final) must equal phase 4's engine-served one, with no
   cache hit; QPS, p50/p99 from ``db.stats()`` and the scheduler's share
   of the wall (wall minus the engine's ``step``). (b) The first 16 again
   through a second ``LaneScheduler`` over a fresh ``MutableBackend``,
   lockstep admission, the drr policy and two tenants: the same results,
   and served + shed + deferred + cache hits == offered. (c) The 64 again:
   every result the cache admitted in (a) must hit, equal (a)'s bits, and
   pass ``theorem2_recheck`` of its frontier rescored by the plain
   similarity against the query that received it. (d) 200 deep-like rows
   upserted and 64 ids of (a)'s results deleted, then the 64 queries and
   the first 16 new rows as queries: no deleted id served, every
   certificate passes ``theorem2_recheck`` over the live corpus, each new
   row leads its merged frontier and is served first unless leaving it
   out is the optimum (a diverse set holding it totals no more). (e)
   ``db.rebuild(wait=False)`` while 32 fresh queries are served, then the
   epoch swap and 16 more: every result valid at its (epoch, version)
   tag, exactly one swap; the rebuild's seconds and the swap's drain
   time. (e) runs on a facade built from the first ``FD_REBUILD_ROWS`` =
   62 500 rows with (d)'s writes (listed under ``reduced``: at 1M rows it
   took the whole script past 600 s; at 125 000, with phase 11 added, the
   whole script took 1 501 s). Phase 7 must launch sim_many,
   sim_gather, the adjacency and the fused round; launches of its checks
   are not counted.

8. The sharded facade and elastic rescaling. (a) Phase 6's facade serves
   phase 6 (d)'s 64 queries with ``search_batch``: each result (ids, score
   bits, certificate, K_final) must equal phase 6 (d)'s, with no cache
   hit; QPS, p50/p99 from ``db.stats()`` and the scheduler's share of the
   wall. (b) ``DiverseVectorDB(rows, "l2", shards="auto",
   elastic=ElasticPolicy(...), num_lanes=8)`` over the first ``EL_ROWS``
   = 62 500 rows (listed under ``reduced``: with 250 000 and 125 000 the
   script took 650 s and 672 s): ``compat.device_count()`` is
   4, so it starts on 2 shards with the 4-shard target (16 lanes)
   resharded and prewarmed at construction (seconds of each). Engine-
   direct straddles on a bare engine over the same two indexes (16 lanes,
   K0 = 16, eps at G^eps degree 100 over these rows): lanes admitted on 2
   shards step once, ``rescale(4)``, finish; then 4 -> 2. Each straddling
   lane must equal ``sharded_diverse_search`` on the final mesh at its
   K_final, or be certified and pass ``theorem2_recheck`` of its frontier;
   each event's pause is timed between device syncs. Then a burst of the
   64 queries and idle pumps through the scheduler: at least one grow, one
   shrink and one request admitted on the new mesh, every request served
   certified and diverse, ``signature_log.unplanned == []``; QPS before
   and after the grow, each event's pause. (c) On (b)'s facade: 200
   upserts and 64 deletes, then ``db.rebuild(wait=False)`` while the 64
   queries are served (the burst grows the mesh while the 2-shard epoch
   builds), the swap (which reshards the rebuilt epoch onto 4 shards) and
   16 fresh queries: every result valid at its (epoch, version) tag, no
   deleted id served, every certificate re-proved by ``theorem2_recheck``,
   epochs {0, 1}, one swap, one reshard; the rebuild's and the reshard's
   seconds and the drain. Phase 8 must launch sim_many, sim_gather, the
   adjacency and topk_merge; launches of its checks are not counted.

9. The paper's per-query API on phase 4's graph, eps and queries; it
   builds nothing. (a) ``diverse_search(graph, q, k=10, eps, method=m,
   ef=40)`` for m in pss, pgs, pds (PDS with ``max_K = PDS_MAX_K`` = 256,
   cut from benchmarks/table2.py's 1 024) over the first ``Q9`` = 4
   queries, PDS over the first ``PDS_QUERIES`` = 1 (both cut from 8; the
   three cuts listed under ``reduced``: at 8 phase 9 took 626 s, and at
   max_K = 1 024 its PDS query and check ~180 s of a 1 501 s script), one
   at a time: each pss result must equal
   phase 4's served one (ids, score bits, certificate, exhausted, K_final,
   growths), each pgs result the lane of ``batch_pgs`` over the same
   queries (ids, score bits, K), each pds result the lane of ``batch_pds``
   (ids, score bits, certificate, exhausted, K_final). (b) The Greedy baseline (L = 400), IP-greedy
   (lam = 0.7, L = 400) and ``div_astar_oracle`` (exact top-X on the card,
   X = 1024 doubling until Theorem 2 certifies) on the same queries: per
   method the synced wall per query (p50, mean), the mean total score,
   recall against the oracle's ids (benchmarks/common.py's), K_final mean
   and max, the certified share; PDS's N/A count; the oracle's final X.
   (c) ``batch_greedy_diverse`` (L = 256) and ``batch_optimal_diverse``
   (K = 128, ef = 4) over the first 16 queries (benchmarks/batch_bench.py's
   values): each greedy lane must equal ``greedy_fixed`` at L = 256 (ids,
   score bits); wall and certified share. Every result must be distinct
   and valid, with k ids unless exhausted (N/A), and diverse but
   IP-greedy's, which takes no eps (its pairs above eps are counted).
   Phase 9 must launch sim_many, sim_gather, the adjacency and greedy; its
   launches are logged by (lanes, width), and the single-lane adjacency
   and greedy are held against their plain versions on tie-free prefixes
   at the phase's most frequent single-lane width and its widest (the
   oracle's X), and timed there beside their bounds (``path9_shapes`` in
   their rows).

10. The paper's index (HNSW) on the first ``N10`` = 10 000 rows of phase
   4's corpus (half of benchmarks/datasets.py's N_DEFAULT; listed under
   ``reduced``: the builder is host code, one insert at a time, and at
   20 000 rows the script passed its time limit) and phase 4's queries,
   eps calibrated on those rows as phase 4's. The query counts of (c) and
   (d) are cuts too (listed under ``reduced``: at 64 / 4 / 4 the script
   took 1 386.8 s; at 16 / 2 / 2 about 1 122 s before phase 11). (a)
   ``HNSWBuilder(rows, "l2", M=12, ef_construction=80, seed=0)``
   (load_graph's settings) and phase 4's KNN builder (M = 16): seconds, ms
   per insert, the levels, nodes per level, the entry and the share of
   level-0 nodes reachable from it; every id in [-1, N10), at least one
   upper level, the entry on the top level. (b) Beam recall@10 and steps
   (k = 10) against the exact top-10 on both graphs at L = 40, and on the
   HNSW graph at 100 and 200; ``batch_beam_search`` equal to its loop. (c)
   A prewarmed 16-lane ``ProgressiveEngine`` (k = 10, ef = 40) on each
   graph serves the first ``SERVED10`` = 16 queries as phase 4's does:
   QPS, p50/p99, certified share, the admissions' and ``descend``'s synced
   ms; every result diverse, the lockstep ``batch_pss`` of the first 16
   and the plain rerun of the first ``RERUN10`` = 1 equal to the engine.
   (d) ``diverse_search`` pss, pgs and greedy (L = 400) on the HNSW graph
   and pss on the KNN graph over the first ``Q10`` = 1 query, and
   ``div_astar_oracle`` (X = 1 024): wall, mean total, recall against
   the oracle, K_final, certified share; each per-query pss equal to its
   graph's engine-served result (ids, score bits, certificate, exhausted,
   K_final, growths). (e) On the
   first ``FD10_ROWS`` = 1 024 rows, eps calibrated on them:
   ``DiverseVectorDB(builder="hnsw")`` at its defaults (M = 16,
   ef_construction 200) serves 16 queries bit-equal to a bare engine over
   its graph, takes 8 upserts and 8 deletes of served ids, and rebuilds in
   the background while batches of 16 reads are served (their p50 beside
   the reads' before), then swaps: no deleted id served, every certificate
   re-proved by ``theorem2_recheck``, the rebuilt graph with upper levels.
   Then ``build_sharded_index(rows, 4, builder="hnsw")`` and
   ``reshard_index`` to 2 shards, shard 0 equal to ``build_hnsw``'s level 0
   of its rows each time; ``sharded_diverse_search`` (K = 32) diverse and
   ``sharded_topk``'s recall@10. Phase 10 must launch sim_many, sim_gather,
   the adjacency, the fused round and topk_merge; launches of its checks
   are not counted. ``tools/torch_hnsw_path.py`` runs it alone.
11. The RAG serving path (run after phase 7, while phase 4's graph is on
   the card): (a) qwen2-1.5b (the JAX launcher's default arch) at full
   width and all 28 layers, ``init_params`` on the card from a generator
   seeded ``--seed + 500`` (parameters, bytes, seconds). (b)
   ``RagPipeline(cfg, params, db=DiverseVectorDB(index=graph, ...), k=10,
   eps, ef=40)``, the facade at phase 7 (a)'s settings with no cache,
   ``generate`` for the first ``RAG_Q`` = 16 queries with 8 seeded prompt
   tokens each and 16 steps: the retrieved ids and certificates must equal
   phase 4's served results, every row diverse; retrieval wall and QPS,
   each decode step synced (median ms, tokens/s) beside the weight-read
   bound (the parameters' bytes over 3.35 TB/s). (c) The decode logits
   along the generated sequence against ``forward`` on it (teacher
   forced) within 8 bf16 ulps of the largest |logit|, and at 2 layers and
   full width 4 decode steps on the card against the plain version on the
   CPU on the same parameters within 4; the argmax equal wherever the
   reference's top-2 margin exceeds twice the tolerance (the share
   compared is printed). (d) 4 decode steps under torch.profiler: launches a step and
   the device's idle share. Phase 11 must launch sim_many, sim_gather, the
   adjacency and the fused round (its retrieval); the model is plain torch
   (the JAX model has no Pallas kernel).
12. The other model families (run after phase 11, while phase 4's graph
   is on the card), one arch of each at full width: moonshot-v1-16b-a3b
   (moe, 48 layers), mamba2-370m (ssm), recurrentgemma-9b (hybrid, 38
   layers: 12 RRA superblocks and two recurrent tail blocks),
   whisper-small (encdec) and llama-3.2-vision-90b at ``FAM_VLM_LAYERS`` =
   10 layers (vlm; listed under ``reduced``: 210 GB of bf16 weights do not
   fit one 80 GB card). Each (a) ``init_params`` on the card from
   ``Generator(--seed + 600 + i)``; (b) ``RagPipeline(cfg, params, db=...)``
   on ONE ``DiverseVectorDB(index=graph, cache_size=64)`` generating for
   the first 16 queries, 8 prompt tokens and 8 steps: the first family's
   retrieval fills the cache, the others hit it, and every family's ids and
   certificates must equal phase 4's served results, every row diverse;
   (c) ms a synced decode step (median), tokens/s beside the step's read
   bound (the parameters a decode step reads, plus its cache read once and
   its recurrent state written once, over 3.35 TB/s), 4 decode steps under
   torch.profiler (launches a step, the device's idle share) and
   ``max_memory_allocated``; (d) decode against ``forward`` on the served
   sequence within 8 bf16 ulps (moe at capacity_factor = E / topk, where
   no pair drops; the served capacity drops different pairs in the two
   paths; encdec with its cross cache filled from the encoder's output of
   seeded frames), and the card against the plain CPU at the least depth
   that holds each block kind once (moe 2, ssm 2, hybrid 3, encdec 2 + 2,
   vlm 5 + 1) within 4, vlm's gates at 0.5 and the cross caches seeded so
   that the cross-attention contributes. Every model is freed before phase
   8. Phase 12 must launch what phase 11 does (its retrieval);
   ``tools/torch_rag_path.py --phase12`` runs phases 4 and 12 alone.

Each phase's wall is logged on a line of its own and kept under
``phase_walls_s`` in chiprun_out/chip_smoke.json, beside the script's.

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
import gc
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
# phase 7: the serving front door on phase 4's graph (cache and delta sizes,
# the writes, and the queries of each part); FD_REBUILD_ROWS cuts (e) to a
# facade of that many rows (None: (e) on phase 4's graph): its rebuild at
# 1M rows took the whole script past 600 s; at 125 000 rows, with phase 11
# added, the whole script took 1 501 s
FD_CACHE, FD_DELTA, FD_UPSERTS, FD_DELETES, FD_SELF_QUERIES = 64, 256, 200, 64, 16
FD_REGIME_QUERIES, FD_REBUILD_QUERIES, FD_AFTER_SWAP = 16, 32, 16
FD_REBUILD_ROWS = 62_500
PATH7_KERNELS = ("batch_similarity_many", "batch_similarity_gather",
                 "pairwise_adjacency", "fused_round")
# phase 8: the sharded facade (phase 6's, at 1M rows) and elastic rescaling
# on a facade of the first EL_ROWS rows (250 000 and 125 000 took the
# whole script to 650 s and 672 s, past its 600 s budget), 2 shards of EL_LANES lanes with the
# 4-shard target of twice the lanes; its prewarm runs the budget ladder up
# to EL_PREWARM_CAP so the burst meets planned signatures only; the
# engine-direct straddles run EL_STRADDLE_LANES lanes from a lower budget
# (K0 = EL_STRADDLE_K0), so more lanes are still running at the event
EL_ROWS, EL_LANES, EL_PREWARM_CAP = 62_500, 8, 64
EL_STRADDLE_LANES, EL_STRADDLE_K0 = 16, 16
EL_POLICY = dict(shrink_depth=0, sustain=2, shrink_sustain=3, cooldown=3)
PATH8_KERNELS = ("batch_similarity_many", "batch_similarity_gather",
                 "pairwise_adjacency", "topk_merge")
# phase 9: the paper's per-query API on phase 4's graph, eps and first Q9
# queries (PDS on the first PDS_QUERIES of them): PDS's max_K
# (benchmarks/table2.py:42), the oracle's X (benchmarks/common.py:33), the
# fixed beam of the Greedy and IP-greedy baselines, and the batch
# baselines' queries and budgets (benchmarks/batch_bench.py:149,158). Both
# counts are cuts (listed under ``reduced``): at 8 queries each phase 9 took
# 626 s (tools/torch_per_query_path.py on an H100), 350 s of it PDS, which
# at this eps stabilises up to max_K * ef = 40 960 candidates for a query
# it then flags N/A (7 of 8), and ~200 s its batch_pds check. PDS_MAX_K is
# cut too, from table2.py's TABLE2_MAX_K: at 1 024 the one PDS query took
# 83.0 s and its batch_pds check ~100 s of a 1 501 s script
Q9, PDS_QUERIES = 4, 1
TABLE2_MAX_K, PDS_MAX_K = 1024, 256
ORACLE_X, GREEDY_L, IPG_LAM = 1024, 400, 0.7
BATCH_Q, BATCH_L, BATCH_K, BATCH_EF = 16, 256, 128, 4
PER_QUERY_METHODS = ("pss", "pgs", "pds")
PATH9_KERNELS = ("batch_similarity_many", "batch_similarity_gather",
                 "pairwise_adjacency", "greedy_diversify")
# phase 10: the paper's index (benchmarks/datasets.py load_graph's builder
# and settings, M = 12, ef_construction = 80) over the first N10 rows of
# phase 4's corpus, half the benchmarks' N_DEFAULT (datasets.py:29; the cut
# is listed under ``reduced``: at 20 000 rows the script took 1 260.5 s);
# each graph's engine serves the first SERVED10 queries and reruns RERUN10
# on the plain versions, the per-query API runs on the first Q10 (cuts
# listed under ``reduced``: at 64 / 4 / 4 the script took 1 386.8 s, and
# at 16 / 2 / 2 phases 1-9 (799.3 s) and phase 10 (322.9 s) add up to
# 1 122 s before phase 11); the
# facade
# (builder="hnsw" at its defaults, M = 16, ef_construction = 200), its
# writes and background rebuild (reads served while it runs, at most
# FD10_MAX_ROUNDS batches), and the sharded path on the first FD10_ROWS rows
N10, M10, EFC10 = 10_000, 12, 80
SERVED10, RERUN10, Q10 = 16, 1, 1
FD10_ROWS, FD10_SHARDS, FD10_WRITES, FD10_QUERIES = 1_024, 4, 8, 16
FD10_MAX_ROUNDS = 64
PATH10_KERNELS = ("batch_similarity_many", "batch_similarity_gather",
                  "pairwise_adjacency", "fused_round", "topk_merge")
# phase 11: RAG at the full width of the JAX launcher's default arch
# (src/repro/launch/serve.py), all its layers: retrieval for the first
# RAG_Q queries, RAG_PROMPT seeded prompt tokens each, RAG_STEPS greedy
# tokens. Logits are held to bf16 ulps of the largest |logit|: decode
# against the forward pass through all 28 layers to RAG_FWD_ULPS (each
# layer's bf16 roundings may fall apart between the two paths' matmul
# shapes and softmax forms; 2.73 measured on a 200 000-row run), the card
# against the plain CPU at RAG_CPU_LAYERS layers over RAG_CPU_STEPS steps
# to RAG_LOGIT_ULPS (the CPU tests' bound at 2 layers);
# RAG_PROFILE_STEPS decode steps profiled
RAG_ARCH, RAG_Q, RAG_PROMPT, RAG_STEPS = "qwen2-1.5b", 16, 8, 16
RAG_FWD_ULPS, RAG_LOGIT_ULPS = 8, 4
RAG_CPU_LAYERS, RAG_CPU_STEPS, RAG_PROFILE_STEPS = 2, 4, 4
PATH11_KERNELS = ("batch_similarity_many", "batch_similarity_gather",
                  "pairwise_adjacency", "fused_round")
# phase 12: the other families at full width through RagPipeline, one
# arch of each, seeded Generator(seed + 600 + i); vlm cut to FAM_VLM_LAYERS
# (2 of its 20 superblocks: 210 GB of bf16 weights do not fit one 80 GB
# card). Each serves the first RAG_Q queries (RAG_PROMPT prompt tokens,
# FAM_STEPS new ones) on one DiverseVectorDB with a FAM_CACHE-entry result
# cache. Decode is held against forward (moe at capacity_factor = E / topk,
# where no pair drops) to FAM_FWD_ULPS, and the card against the plain CPU
# at FAM_CHECK_DEPTH (each block kind once) over FAM_CPU_STEPS steps to
# RAG_LOGIT_ULPS. ssm's bound is wider: the reference's decode rounds the
# SSD output to bf16 before its skip term and its forward does not
# (src/repro/models/ssm.py:93 against :81), one rounding more a layer over
# 48 (10.4-10.7 ulps on an NVIDIA H100 80GB HBM3). moe's logits are held
# with the second path's routes replayed from the first (RouteLog): at
# moonshot's width a bf16 flip of the hidden state moves the router's 6th
# and 7th experts past each other in ~6 % of the forward's (token, layer)
# routes against the decode's (5.5-5.8 % on the same card), and one
# flipped route moves a token's logits by tens of ulps
FAM_ARCHS = ("moonshot-v1-16b-a3b", "mamba2-370m", "recurrentgemma-9b",
             "whisper-small", "llama-3.2-vision-90b")
# (cut to keep the phase near 120 s: FAM_STEPS 8 new tokens, not phase
# 11's 16, and fewer CPU steps for the widest blocks, each listed under
# ``reduced``; 129.4 s at 16 over 200 000 rows on an NVIDIA H100 80GB HBM3
# at 700 W)
FAM_VLM_LAYERS, FAM_CACHE, FAM_STEPS = 10, 64, 8
FAM_FWD_ULPS = {"moe": 8, "ssm": 16, "hybrid": 8, "encdec": 8, "vlm": 8}
FAM_CHECK_DEPTH = {"moe": dict(num_layers=2), "ssm": dict(num_layers=2),
                   "hybrid": dict(num_layers=3),
                   "encdec": dict(num_layers=2, encoder_layers=2),
                   "vlm": dict(num_layers=5)}
FAM_CPU_STEPS = {"moe": 2, "ssm": 4, "hybrid": 2, "encdec": 4, "vlm": 1}
PATH12_KERNELS = PATH11_KERNELS
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


def deep_like(torch, n: int, d: int, seed: int, device,
              row_seed: int | None = None):
    """The repo's deep-like mixture (64 Gaussian centres, noise 0.7), made
    on the card from ``seed``; with ``row_seed``, n further rows of the
    same mixture (its centres from ``seed``, the rows from ``row_seed``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((64, d), generator=g, device=device)
    if row_seed is not None:
        g = torch.Generator(device=device).manual_seed(row_seed)
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
    """Wall time and calls of the engine's stages, each closed by a device
    sync."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self._wrapped: list = []

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
            self.calls[stage] = self.calls.get(stage, 0) + 1
            return out

        setattr(module, attr, timed)
        self._wrapped.append((module, attr, fn))

    def restore(self):
        """Put back every function this timer wrapped."""
        for module, attr, fn in reversed(self._wrapped):
            setattr(module, attr, fn)
        self._wrapped.clear()


def device_events(torch, prof) -> list[tuple[str, float]]:
    """(name, duration in µs) of every device activity ``prof`` recorded,
    read from the profiler's kineto events as ``prof.events()`` reads
    them, without building its Python event tree: the same events and
    sums, several times quicker (``tools/torch_smoke_costs.py``)."""
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


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
    kernels = device_events(torch, prof)
    log(f"profile parsed in {time.perf_counter() - t0:.1f} s")
    busy_us = sum(dur for _, dur in kernels)
    by_name: dict[str, float] = {}
    for name, dur in kernels:
        by_name[name] = by_name.get(name, 0.0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the gathered scoring's launches that the profiler kept with a duration
    gather = [dur for name, dur in kernels
              if "sim_gather" in name and dur > 0]
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


def pairs_above(torch, sim, x, ids, eps) -> int:
    """Pairs of a batch of results ids [B, k] whose similarity is above eps
    (the kernels' arithmetic, sim.cuh's order, which dot_seq reproduces)."""
    rows = x[ids.clamp(min=0).long()]
    pair = sim.query_sim(rows[:, :, None, :], rows[:, None, :, :], "l2")
    valid = ids >= 0
    off = ~torch.eye(ids.shape[1], dtype=torch.bool, device=ids.device)
    return int(((pair > eps) & off & valid[:, :, None]
                & valid[:, None, :]).sum()) // 2


def assert_results(torch, sim, x, ids, scores, eps, what):
    """Result ids [B, K] in range, finite scores, no duplicate, and no two
    returned ids G^eps neighbours (``pairs_above``)."""
    n = x.shape[0]
    k = ids.shape[1]
    if bool(((ids < -1) | (ids >= n)).any()):
        raise AssertionError(f"{what}: ids out of range")
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"{what}: non-finite scores")
    bad = pairs_above(torch, sim, x, ids, eps)
    if bad:
        raise AssertionError(f"{what}: {bad} result pairs violate sim < eps")
    valid = ids >= 0
    off = ~torch.eye(k, dtype=torch.bool, device=ids.device)
    dup = (ids[:, :, None] == ids[:, None, :]) & off & valid[:, :, None]
    if bool(dup.any()):
        raise AssertionError(f"{what}: duplicate ids in a result")


def calibrate_eps(torch, sim, x, seed, device) -> float:
    """eps at an expected G^eps degree of PHI over the rows of ``x``:
    (n - 1) * P(sim > eps), from 4096^2 sampled pairs."""
    n = x.shape[0]
    g = torch.Generator(device=device).manual_seed(seed)
    m = 4096
    a = x[torch.randint(0, n, (m,), generator=g, device=device)]
    b = x[torch.randint(0, n, (m,), generator=g, device=device)]
    s = sim.pairwise_sim(a, b, "l2").flatten()
    rank = int(math.ceil((1.0 - PHI / (n - 1)) * s.numel()))
    return float(torch.kthvalue(s.cpu(), max(1, min(rank, s.numel()))).values)


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

    eps = calibrate_eps(torch, sim, graph.vectors, args.seed + 1, device)
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
    return launches, graph, qs, eps, results


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
    Returns topk_merge's row, the path's launches of every kernel, the
    sharded facade its index was built through, and the engine's results
    (query order)."""
    import dataclasses

    from repro_torch import quant
    from repro_torch import sharded_search as ss
    from repro_torch.compat import make_mesh
    from repro_torch.core import similarity as sim
    from repro_torch.core.backend import LaneRequest
    from repro_torch.db import DiverseVectorDB
    from repro_torch.index import flat
    from repro_torch.kernels import ops
    from repro_torch.sharded_search import search as ssearch

    out: dict = {}
    row, out["topk_merge_times"] = check_topk_merge(torch, device, seed)

    # (b) set-up: the shard graphs on the card, built through the sharded
    # facade (phase 8 (a) serves through it), and an int8 copy
    x = graph.vectors
    x_np = x.cpu().numpy()
    n = x.shape[0]
    build_timer = StageTimer(torch)
    for attr in ("_exact_knn", "_alpha_prune", "_add_reverse_edges",
                 "_stitch_components", "_directed_repair"):
        build_timer.wrap(flat, attr, attr.lstrip("_"))
    db, out["build_s"] = synced(torch, lambda: DiverseVectorDB(
        x_np, "l2", shards=SHARDS, M=M_GRAPH, num_lanes=LANES, max_k=K,
        default_ef=EF, cache_size=FD_CACHE, delta_capacity=FD_DELTA,
        backend_kw=dict(K0=K0, L_factor=L_FACTOR, max_rounds=MAX_ROUNDS,
                        resume="beam"), device=device))
    index = db.index.sharded
    if db.index.n_total != n:
        raise AssertionError(f"the facade padded {n} rows to "
                             f"{db.index.n_total}")
    out["build_stage_s"] = build_timer.seconds
    c8 = [quant.quantize_int8(index.vectors[s], scale_rows=SCALE_ROWS)
          for s in range(SHARDS)]
    index8 = dataclasses.replace(
        index, vectors=None, codes=torch.stack([c.codes for c in c8]),
        scales=torch.stack([c.scales for c in c8]), scheme="int8",
        scale_rows=SCALE_ROWS)
    del c8
    log(f"sharded index: {SHARDS} shards of {index.shard_size} rows, "
        f"M={M_GRAPH}, built on the card through DiverseVectorDB(shards="
        f"{SHARDS}) in {out['build_s']:.1f} s: "
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
    return row, launches, db, results


# ------------------------------------------------------------- phase 7 ----

class PathLaunches:
    """Kernel launches of a path driven in parts: ``bank()`` adds the
    counters to the path's total and zeroes them, ``drop()`` zeroes them
    (launches of a check, not of the path)."""

    def __init__(self, ops):
        self.ops = ops
        self.total = {name: 0 for name in ops.KERNELS}
        ops.reset_launch_counts()

    def bank(self):
        for name, n in self.ops.launch_counts().items():
            self.total[name] += n
        self.ops.reset_launch_counts()

    def drop(self):
        self.ops.reset_launch_counts()


def serve_polled(sched, backend, index, queries, snaps=None):
    """Submit every query (pumping on backpressure, a shed request gives
    None), then pump until all are done. After every pump each completed
    request's harvest-time tag ``(epoch, version)`` and merged frontier are
    read from the backend's lane slots (a slot holds until the lane's next
    harvest); a cache hit is tagged with the index's snapshot at its
    submit. Returns (requests, tags, frontiers) keyed by position."""
    from repro_torch.serve.scheduler import (RequestDeferred, RequestShed,
                                             SchedulerSaturated)

    reqs, tags, fronts = [], {}, {}

    def poll():
        for i, r in enumerate(reqs):
            if r is None or r.result is None or i in tags:
                continue
            if r.lane is not None:
                meta = backend.last_meta[r.lane]
                tags[i] = (meta["epoch"], meta["version"])
                fronts[i] = backend.last_candidates[r.lane]

    for q in queries:
        while True:
            try:
                r = sched.submit(q)
                if r.cache_hit:
                    tags[len(reqs)] = (index.epoch, index.version)
                reqs.append(r)
                break
            except RequestShed:
                reqs.append(None)
                break
            except (SchedulerSaturated, RequestDeferred):
                sched.pump()
                poll()
    while any(r is not None and r.result is None for r in reqs):
        sched.pump()
        poll()
    return reqs, tags, fronts


def oracle_frontier(torch, sim, index, q, cand_ids, device):
    """A cached frontier as a plain audit of a hit sees it, scored against
    ``q`` by the plain similarity on the card: before any write, the stored
    frontier rescored (padding kept at the tail); after writes, its live
    rows plus every live delta row, in (score desc, id asc) order."""
    cand = np.asarray(cand_ids, np.int64)
    if not index.mutated:
        rows = torch.as_tensor(index.float_view()[np.maximum(cand, 0)],
                               device=device)
        sc = sim.query_sim(torch.as_tensor(q, device=device), rows,
                           index.metric).cpu().numpy()
        sc = np.where(cand >= 0, sc, -np.inf).astype(np.float32)
        order = np.argsort(-sc, kind="stable")
        return cand[order], sc[order]
    g = cand[(cand >= 0) & ~index.deleted[np.maximum(cand, 0)]]
    d = index.delta_ids()
    ids = np.concatenate([g, d[~np.isin(d, g)]])
    rows = torch.as_tensor(index.float_view()[ids], device=device)
    sc = sim.query_sim(torch.as_tensor(q, device=device), rows,
                       index.metric).cpu().numpy()
    order = np.lexsort((ids, -sc))
    return ids[order], sc[order]


def check_self_query(torch, ops, da, index, res, front, self_id, eps,
                     device) -> bool:
    """An upserted row used as a query: the delta merge must rank it first
    in the merged frontier, and the served set must hold it first — unless
    the set served without it totals more than the best diverse set that
    holds it (over the same frontier and the same adjacency kernel), so
    that leaving it out is the optimum. Returns whether it came first."""
    ids, sc = front[0], front[1]
    if int(ids[0]) != self_id:
        raise AssertionError(f"(d) upserted row {self_id} as a query: the "
                             f"merged frontier starts with {int(ids[0])}")
    if int(res.ids[0]) == self_id:
        return True
    if self_id in res.ids.tolist():
        raise AssertionError(f"(d) upserted row {self_id} served, not first")
    rows = torch.as_tensor(index.float_view()[ids.astype(np.int64)],
                           device=device)
    adj = ops.pairwise_adjacency(rows, eps, index.metric).cpu().numpy()
    free = ~adj[0]
    free[0] = False
    k = len(res.ids)
    best = da.div_astar(np.where(free, sc, -np.inf), adj, k - 1)
    with_self = np.float32(sc[0]) + best.best_scores[k - 2]
    if not with_self <= np.float32(res.total):
        raise AssertionError(f"(d) upserted row {self_id} left out of a set "
                             f"totalling {res.total}, though a diverse set "
                             f"holding it totals {with_self}")
    return False


def check_valid_at_tag(results, tags, snaps, what):
    """Every served id inside its snapshot's row range and live there."""
    for i, r in enumerate(results):
        epoch, version = tags[i]
        n_at, dele_at = snaps[max(v for v in snaps if v <= version)]
        ids = r.ids[r.ids >= 0]
        if not ids.size or (ids >= n_at).any() or dele_at[ids].any():
            raise AssertionError(f"{what}: request {i} serves ids not live "
                                 f"at its tag (epoch {epoch}, version "
                                 f"{version})")


def front_door(torch, report, graph, qs_np, eps, served4, seed, device):
    """Phase 7: the serving front door (``DiverseVectorDB``) on phase 4's
    graph, eps and queries. Returns the path's launches of every kernel."""
    from repro_torch.core import div_astar as da
    from repro_torch.core import similarity as sim
    from repro_torch.core import theorems
    from repro_torch.core.batch_progressive import ProgressiveEngine
    from repro_torch.db import DiverseVectorDB, Query
    from repro_torch.index.mutable import MutableBackend, MutableIndex
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import LaneScheduler

    out: dict = {}
    nq = len(qs_np)
    queries = [Query(q, k=K, eps=eps) for q in qs_np]
    path = PathLaunches(ops)
    t_path = time.perf_counter()

    # (a) reads through the facade, with the cache attached
    t0 = time.perf_counter()
    db = DiverseVectorDB(index=graph, metric="l2", num_lanes=LANES, max_k=K,
                         default_ef=EF, cache_size=FD_CACHE,
                         delta_capacity=FD_DELTA, scheduler_kw=dict(
                             prewarm_capacity=1024, prewarm_ks=(K,),
                             prewarm_widths=(64,)), device=device)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    step_s = [0.0]
    engine_step = db.engine.step

    def timed_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        done = engine_step()
        torch.cuda.synchronize()
        step_s[0] += time.perf_counter() - t
        return done

    db.engine.step = timed_step
    t0 = time.perf_counter()
    res_a = db.search_batch(queries)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    st = db.stats()
    path.bank()
    for i, (r, p) in enumerate(zip(res_a, served4)):
        if not (np.array_equal(r.ids, p.ids)
                and np.array_equal(r.scores.view(np.int32),
                                   p.scores.view(np.int32))
                and r.stats.certified == p.stats.certified
                and r.stats.K_final == p.stats.K_final):
            raise AssertionError(f"(a) query {i}: the facade's result differs "
                                 f"from phase 4's engine:\n{r}\n{p}")
    if st["cache_hits"]:
        raise AssertionError(f"(a): {st['cache_hits']} cache hits on "
                             "distinct queries")
    admitted = {i for i in range(nq) for e in db.cache._entries.values()
                if np.array_equal(e.q, qs_np[i])}
    out["a"] = dict(
        queries=nq, wall_s=wall_a, qps=nq / wall_a,
        p50_latency_s=st["p50_latency"], p99_latency_s=st["p99_latency"],
        throughput=st["throughput"], engine_step_s=step_s[0],
        scheduler_share=(wall_a - step_s[0]) / wall_a,
        certified_share=st["certified_frac"], cache_admitted=len(admitted),
        bit_equal_to_phase4=True)
    log("phase 7 (a) facade, 64 queries, bit-equal to phase 4, 0 hits: "
        + json.dumps(out["a"]))

    # (b) the lockstep regime and the drr policy on a second stack
    eng_b = ProgressiveEngine(graph, LANES, max_k=K, default_ef=EF)
    sched_b = LaneScheduler(
        backend=MutableBackend(eng_b, MutableIndex(graph=graph,
                                                   device=device)),
        admission="lockstep", policy="drr", prewarm=False)
    offered = [Query(q, k=K, eps=eps, tenant=("a", "b")[i % 2])
               for i, q in enumerate(qs_np[:FD_REGIME_QUERIES])]
    t0 = time.perf_counter()
    reqs_b, _, _ = serve_polled(sched_b, sched_b.backend, None, offered)
    wall_b = time.perf_counter() - t0
    path.bank()
    st_b = sched_b.latency_stats()
    served_b = sum(1 for r in reqs_b if r is not None and r.lane is not None)
    if served_b + st_b["shed"] + st_b["deferred"] + st_b["cache_hits"] \
            != len(offered):
        raise AssertionError(f"(b): conservation fails: {st_b}")
    for i, r in enumerate(reqs_b):
        if r is None or not (np.array_equal(r.result.ids, res_a[i].ids)
                             and np.array_equal(r.result.scores,
                                                res_a[i].scores)
                             and r.result.stats.certified
                             == res_a[i].stats.certified):
            raise AssertionError(f"(b) query {i}: lockstep + drr differs")
    out["b"] = dict(queries=len(offered), wall_s=wall_b, served=served_b,
                    shed=st_b["shed"], deferred=st_b["deferred"],
                    cache_hits=st_b["cache_hits"],
                    p50_latency_s=st_b["p50_latency"],
                    p99_latency_s=st_b["p99_latency"],
                    tenant_fairness=st_b["tenant_fairness"])
    log("phase 7 (b) lockstep + drr, 2 tenants: same results, "
        "conservation holds: " + json.dumps(out["b"]))
    del sched_b, eng_b

    # (c) the 64 queries again: every admitted result hits
    hits_before = db.stats()["cache_hits"]
    t0 = time.perf_counter()
    reqs_c, _, _ = serve_polled(db.scheduler, db.backend, db.index, queries)
    wall_c = time.perf_counter() - t0
    path.bank()
    hit_lat = []
    for i, r in enumerate(reqs_c):
        if r.cache_hit != (i in admitted):
            raise AssertionError(f"(c) query {i}: admitted {i in admitted}, "
                                 f"hit {r.cache_hit}")
        if not (np.array_equal(r.result.ids, res_a[i].ids)
                and np.array_equal(r.result.scores.view(np.int32),
                                   res_a[i].scores.view(np.int32))):
            raise AssertionError(f"(c) query {i}: differs from (a)")
        if r.cache_hit:
            hit_lat.append(r.latency)
            e = r.cache_entry
            ids, sc = oracle_frontier(torch, sim, db.index, r.q,
                                        e.cand_ids, device)
            ok, sel = theorems.theorem2_recheck(
                db.index.float_view(), "l2", ids, sc, eps, K, device=device)
            if not (ok and np.array_equal(sel, r.result.ids)):
                raise AssertionError(f"(c) query {i}: the hit fails its "
                                     "independent recheck")
    path.drop()
    st = db.stats()
    hit_lat.sort()
    out["c"] = dict(queries=nq, wall_s=wall_c,
                    hits=st["cache_hits"] - hits_before,
                    hit_share=(st["cache_hits"] - hits_before) / nq,
                    hit_p50_latency_s=hit_lat[len(hit_lat) // 2]
                    if hit_lat else None,
                    revalidation_failures=st["cache"][
                        "revalidation_failures"],
                    admission_rejected=st["cache"]["rejected"])
    log("phase 7 (c) duplicates: every admitted result hit, bit-equal and "
        "re-proved: " + json.dumps(out["c"]))

    # (d) writes: upserts and deletes, then the queries and the new rows
    snaps = {db.index.version: (db.index.n_total, db.index.deleted.copy())}
    new = deep_like(torch, FD_UPSERTS, D, seed, device,
                    row_seed=seed + 700).cpu().numpy()
    new_ids = db.upsert(new)
    snaps[db.index.version] = (db.index.n_total, db.index.deleted.copy())
    dead: list[int] = []
    for r in res_a:
        for i in r.ids.tolist():
            if i >= 0 and i not in dead and len(dead) < FD_DELETES:
                dead.append(i)
    db.delete(dead)
    snaps[db.index.version] = (db.index.n_total, db.index.deleted.copy())
    if len(dead) != FD_DELETES:
        raise AssertionError(f"(d): only {len(dead)} ids to delete")
    self_q = [Query(v, k=K, eps=eps) for v in new[:FD_SELF_QUERIES]]
    t0 = time.perf_counter()
    reqs_d, tags_d, fronts_d = serve_polled(db.scheduler, db.backend,
                                            db.index, queries + self_q)
    wall_d = time.perf_counter() - t0
    path.bank()
    res_d = [r.result for r in reqs_d]
    check_valid_at_tag(res_d, tags_d, snaps, "(d)")
    certified_d = 0
    self_first = 0
    for i, r in enumerate(reqs_d):
        if set(dead) & set(r.result.ids.tolist()):
            raise AssertionError(f"(d) query {i}: a deleted id is served")
        if i >= nq:
            self_first += check_self_query(torch, ops, da, db.index,
                                           r.result, fronts_d[i],
                                           int(new_ids[i - nq]), eps, device)
        if not r.result.stats.certified:
            continue
        certified_d += 1
        if r.cache_hit:
            ids, sc = oracle_frontier(torch, sim, db.index, r.q,
                                        r.cache_entry.cand_ids, device)
        else:
            ids, sc = fronts_d[i][0], fronts_d[i][1]
        ok, sel = theorems.theorem2_recheck(db.index.float_view(), "l2", ids,
                                            sc, eps, K, device=device)
        if not (ok and np.array_equal(sel, r.result.ids)):
            raise AssertionError(f"(d) query {i}: the certificate fails "
                                 "theorem2_recheck over the live corpus")
    path.drop()
    st = db.stats()
    out["d"] = dict(upserts=FD_UPSERTS, deletes=len(dead),
                    queries=len(reqs_d), wall_s=wall_d,
                    qps=len(reqs_d) / wall_d,
                    certified_share=certified_d / len(reqs_d),
                    cache_hits=sum(r.cache_hit for r in reqs_d),
                    self_queries=FD_SELF_QUERIES,
                    self_queries_served_first=self_first,
                    cache_invalidations=st["cache_invalidations"],
                    index=st["index"])
    log("phase 7 (d) writes: no deleted id served, every certificate "
        "re-proved, each upserted row leads its merged frontier: "
        + json.dumps(out["d"]))

    # (e) a background rebuild while serving, then the epoch swap
    if FD_REBUILD_ROWS is not None:
        report.setdefault("reduced", []).append(
            f"phase 7 (e) runs on a facade built from the first "
            f"{FD_REBUILD_ROWS} rows (DiverseVectorDB(vectors=...)), with "
            "(d)'s upserts and its deletes below that row: a rebuild at 1M "
            "rows took the script past 600 s; at 125 000 rows, with phase "
            "11 added, the whole script took 1 501 s, its (e) facade build "
            "17.8 s (NVIDIA H100 80GB HBM3, 700 W)")
        t0 = time.perf_counter()
        db = DiverseVectorDB(graph.vectors[:FD_REBUILD_ROWS].cpu().numpy(),
                             "l2", num_lanes=LANES, max_k=K, default_ef=EF,
                             M=M_GRAPH, cache_size=FD_CACHE,
                             delta_capacity=FD_DELTA, prewarm=False,
                             device=device)
        torch.cuda.synchronize()
        out["e_facade_build_s"] = time.perf_counter() - t0
        db.upsert(new)
        db.delete([i for i in dead if i < FD_REBUILD_ROWS])
        path.bank()
        snaps = {db.index.version: (db.index.n_total,
                                    db.index.deleted.copy())}
    fresh = deep_like(torch, FD_REBUILD_QUERIES + FD_AFTER_SWAP, D, seed,
                      device, row_seed=seed + 701).cpu().numpy()
    fresh_q = [Query(v, k=K, eps=eps) for v in fresh]
    marks: dict = {}
    build = db.index._build

    def timed_build(snap):
        t = time.perf_counter()
        g = build(snap)
        torch.cuda.synchronize()
        marks["build_s"] = time.perf_counter() - t
        marks["ready"] = time.perf_counter()
        return g

    swap = db.backend.maybe_swap

    def timed_swap():
        ok = swap()
        if ok:
            marks["swapped"] = time.perf_counter()
        return ok

    db.index._build = timed_build
    db.backend.maybe_swap = timed_swap
    t0 = time.perf_counter()
    db.rebuild(wait=False)
    reqs_e, tags_e, _ = serve_polled(db.scheduler, db.backend, db.index,
                                     fresh_q[:FD_REBUILD_QUERIES])
    serve_e = time.perf_counter() - t0
    served_during_build = "ready" not in marks
    db.index.wait_rebuild()
    db.scheduler.drain()
    db.backend.maybe_swap()
    reqs_f, tags_f, _ = serve_polled(db.scheduler, db.backend, db.index,
                                     fresh_q[FD_REBUILD_QUERIES:])
    path.bank()
    st = db.stats()
    if st["epoch_swaps"] != 1 or db.index.epoch != 1:
        raise AssertionError(f"(e): {st['epoch_swaps']} epoch swaps (the "
                             "background rebuild died?)")
    res_e = [r.result for r in reqs_e + reqs_f]
    tags = dict(tags_e)
    tags.update({len(reqs_e) + i: t for i, t in tags_f.items()})
    check_valid_at_tag(res_e, tags, snaps, "(e)")
    epochs = sorted({t[0] for t in tags.values()})
    out["e"] = dict(
        rows=db.index.n_total, rebuild_s=marks["build_s"],
        swap_drain_s=marks["swapped"] - marks["ready"],
        served_while_building=FD_REBUILD_QUERIES, serve_s=serve_e,
        build_outlasted_serving=served_during_build,
        served_after_swap=FD_AFTER_SWAP, epochs_served=epochs,
        epoch_swaps=st["epoch_swaps"],
        certified_share=float(np.mean([r.stats.certified for r in res_e])))
    log("phase 7 (e) rebuild + epoch swap: every result valid at its tag, "
        "one swap: " + json.dumps(out["e"]))
    out["path_s"] = time.perf_counter() - t_path
    out["launches"] = {k: path.total[k] for k in PATH7_KERNELS}
    missing = [k for k in PATH7_KERNELS if path.total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the front door: "
                             f"{missing}")
    report["front_door"] = out
    log("front door: " + json.dumps({k: v for k, v in out.items()
                                     if k not in ("a", "b", "c", "d", "e")}))
    return path.total


# ------------------------------------------------------------- phase 8 ----

def straddle(torch, eng, qs, eps, to):
    """Engine-direct straddle: ``qs`` admitted, one round, ``rescale(to)``
    (its pause timed between device syncs), the rest of the rounds.
    Returns the lanes that straddled and each finished lane's result and
    frontier, for ``check_straddle``."""
    from repro_torch.core.backend import LaneRequest
    from repro_torch.sharded_search.engine import LANE_RUN

    for lane, q in enumerate(qs):
        eng.admit(lane, LaneRequest(q, K, eps, method="sharded"))
    eng.step()
    for lane, _ in eng.harvest():
        eng.recycle(lane)
    lanes = [int(i) for i in np.flatnonzero(eng.status == LANE_RUN)]
    frm = eng.num_shards
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not eng.rescale(to):
        raise AssertionError(f"rescale({to}) from {frm} shards was a no-op")
    torch.cuda.synchronize()
    pause = time.perf_counter() - t0
    done = {}
    while eng.active_count():
        eng.step()
        for lane, res in eng.harvest():
            done[lane] = (res, eng.last_candidates[lane])
            eng.recycle(lane)
    return dict(frm=frm, to=to, lanes=lanes, pause=pause, done=done)


def check_straddle(ss, theorems, rec, qs, eps, final_index, final_mesh,
                   rows, device, what) -> dict:
    """Every straddling lane must equal ``sharded_diverse_search`` on the
    final mesh at its K_final, or be certified and pass
    ``theorem2_recheck`` of its frontier."""
    fixed = rechecked = 0
    for lane in rec["lanes"]:
        res, (cand_ids, cand_sc) = rec["done"][lane]
        ids, sc, _ = ss.sharded_diverse_search(
            final_index, rows, qs[lane][None], K, eps, res.stats.K_final,
            final_mesh)
        if (np.array_equal(ids[0].cpu().numpy(), res.ids)
                and np.array_equal(sc[0].cpu().numpy().view(np.int32),
                                   res.scores.view(np.int32))):
            fixed += 1
            continue
        ok, sel = theorems.theorem2_recheck(rows, "l2", cand_ids, cand_sc,
                                            eps, K, device=device)
        if not (res.stats.certified and ok and np.array_equal(sel, res.ids)):
            raise AssertionError(f"{what} lane {lane}: neither equal to the "
                                 f"fixed {final_index.num_shards}-shard mesh "
                                 "nor a re-proved certificate")
        rechecked += 1
    return dict(from_shards=rec["frm"], to_shards=rec["to"],
                lanes_straddled=len(rec["lanes"]), equal_to_fixed_mesh=fixed,
                rechecked=rechecked, migration_pause_s=rec["pause"])


def burst_qps(reqs, t0, t_split):
    """Completions per second of the requests before and after ``t_split``
    (the scheduler's clock), from ``t0`` to the last completion."""
    done = sorted(r.t_done for r in reqs)
    before = sum(t < t_split for t in done)
    after = len(done) - before
    return (before / (t_split - t0) if t_split > t0 else None,
            after / (done[-1] - t_split) if after else None)


def sharded_facade(torch, db6, qs_np, eps, served6) -> tuple[dict, dict]:
    """Phase 8 (a): phase 6's 1M-row facade serves phase 6 (d)'s queries.
    Returns the record and the part's launches of every kernel."""
    from repro_torch.db import Query
    from repro_torch.kernels import ops

    nq = len(qs_np)
    queries = [Query(q, k=K, eps=eps) for q in qs_np]
    path = PathLaunches(ops)
    step_s = [0.0]
    engine_step = db6.engine.step

    def timed_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        done = engine_step()
        torch.cuda.synchronize()
        step_s[0] += time.perf_counter() - t
        return done

    db6.engine.step = timed_step
    t0 = time.perf_counter()
    res_a = db6.search_batch(queries)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    path.bank()
    st = db6.stats()
    for i, (r, p) in enumerate(zip(res_a, served6)):
        if not (np.array_equal(r.ids, p.ids)
                and np.array_equal(r.scores.view(np.int32),
                                   p.scores.view(np.int32))
                and r.stats.certified == p.stats.certified
                and r.stats.K_final == p.stats.K_final):
            raise AssertionError(f"(a) query {i}: the sharded facade differs "
                                 f"from phase 6's engine:\n{r}\n{p}")
    if st["cache_hits"]:
        raise AssertionError(f"(a): {st['cache_hits']} cache hits on "
                             "distinct queries")
    out = dict(
        rows=db6.index.n_total, shards=st["shards"], queries=nq,
        wall_s=wall_a, qps=nq / wall_a, p50_latency_s=st["p50_latency"],
        p99_latency_s=st["p99_latency"], engine_step_s=step_s[0],
        scheduler_share=(wall_a - step_s[0]) / wall_a,
        certified_share=st["certified_frac"], bit_equal_to_phase6=True)
    log(f"phase 8 (a) sharded facade at {db6.index.n_total} rows, {nq} "
        "queries, bit-equal to phase 6 (d), 0 hits: " + json.dumps(out))
    db6.engine.step = engine_step
    return out, path.total


def elastic(torch, report, x_np, qs_np, eps, seed, device
            ) -> tuple[dict, dict]:
    """Phase 8 (b) and (c): elastic rescaling on a facade of the first
    ``EL_ROWS`` rows, then writes and a background rebuild with a rescale
    during it. Returns the record and the part's launches of every
    kernel."""
    from repro_torch import compat
    from repro_torch import sharded_search as ss
    from repro_torch.core import similarity as sim
    from repro_torch.core import theorems
    from repro_torch.db import DiverseVectorDB, Query
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import ElasticPolicy
    from repro_torch.sharded_search import engine as sengine
    from repro_torch.sharded_search import search as ssearch

    out: dict = {}
    nq = len(qs_np)
    queries = [Query(q, k=K, eps=eps) for q in qs_np]
    path = PathLaunches(ops)

    # (b) elastic: a facade of the first EL_ROWS rows, 2 shards, with the
    # 4-shard target (twice the lanes) prepared at construction
    report.setdefault("reduced", []).append(
        f"phase 8 (b)-(c) run on an elastic facade built from the first "
        f"{EL_ROWS} rows: a second 1M-row build would take the script past "
        "its 600 s budget, and with 250000 and 125000 rows the whole script "
        "took 650 s and 672 s (NVIDIA H100 80GB HBM3, 700 W)")
    rows = x_np[:EL_ROWS]
    prep = StageTimer(torch)
    prep.wrap(sengine.ShardedEngine, "prepare_rescale", "prepare_rescale")
    prep.wrap(sengine, "reshard_index", "reshard")
    prep.wrap(sengine.ShardedEngine, "_run_ladder", "prewarm")
    policy = ElasticPolicy(grow_depth=EL_LANES, **EL_POLICY)
    db, build_s = synced(torch, lambda: DiverseVectorDB(
        rows, "l2", shards="auto", elastic=policy, num_lanes=EL_LANES,
        max_k=K, default_ef=EF, M=M_GRAPH, backend_kw=dict(resume="beam"),
        scheduler_kw=dict(prewarm_capacity=EL_PREWARM_CAP, prewarm_ks=(K,)),
        device=device))
    prep.restore()
    if (db.backend.num_shards, db.backend.rescale_options(),
            compat.device_count()) != (2, (2, 4), 4):
        raise AssertionError("shards='auto' under elastic= should start on "
                             "2 of 4 shards with the 4-shard target")
    sig = db.engine.signature_log
    sig.freeze()
    index2 = db.index.sharded
    index4 = db.engine._rescale_targets[4][1]
    mesh2 = compat.make_mesh((2,), ("data",), device=device)
    mesh4 = compat.make_mesh((4,), ("data",), device=device)
    path.bank()
    out["b_setup"] = dict(rows=db.index.n_total, facade_build_s=build_s,
                          prepare_rescale_s=prep.seconds["prepare_rescale"],
                          reshard_s=prep.seconds["reshard"],
                          prewarm_s=prep.seconds["prewarm"],
                          lanes=(EL_LANES, db.engine._rescale_targets[4][2]))
    log("phase 8 (b) elastic facade: " + json.dumps(out["b_setup"]))

    # engine-direct straddles on a bare engine over the facade's indexes,
    # at an eps of G^eps degree PHI over these rows (phase 4's eps is degree
    # PHI over 1M rows, so a quarter of that here: most lanes would certify
    # in their first round and none straddle)
    S = EL_STRADDLE_LANES
    eng = ss.ShardedEngine(index2, rows, mesh2, num_lanes=S,
                           K0=EL_STRADDLE_K0, max_k=K, resume="beam",
                           record_candidates=True)
    eng.prepare_rescale(4, mesh4, index=index4, prewarm=False)
    dev_rows = eng.all_vectors
    eps_s = calibrate_eps(torch, sim, dev_rows, seed + 802, device)
    grow = straddle(torch, eng, qs_np[:S], eps_s, 4)
    shrink = straddle(torch, eng, qs_np[S:2 * S], eps_s, 2)
    path.bank()
    out["b_straddle"] = [dict(eps=eps_s, **check_straddle(
        ss, theorems, rec, qs_np[at], eps_s, index, mesh, dev_rows, device,
        what)) for rec, at, index, mesh, what in (
            (grow, slice(0, S), index4, mesh4, "(b) grow"),
            (shrink, slice(S, 2 * S), index2, mesh2, "(b) shrink"))]
    path.drop()
    if not all(r["lanes_straddled"] for r in out["b_straddle"]):
        raise AssertionError("(b): a scale event with no lane straddling "
                             f"it: {out['b_straddle']}")
    del eng, dev_rows
    log("phase 8 (b) engine-direct straddles: "
        + json.dumps(out["b_straddle"]))

    # the burst through the facade's scheduler, then idle pumps
    sched = db.scheduler
    reqs, i = [], 0
    t_burst = sched.clock()
    while i < nq or sched.pending or sched.inflight:
        while i < nq and len(sched.pending) < 2 * EL_LANES:
            reqs.append(sched.submit(queries[i]))
            i += 1
        sched.pump()
    t_end = sched.clock()
    for _ in range(4 * EL_POLICY["shrink_sustain"]):
        sched.pump()
        if any(e["to_shards"] < e["from_shards"] for e in sched.scale_events):
            break
    path.bank()
    grows = [e for e in sched.scale_events if e["to_shards"] > e["from_shards"]]
    shrinks = [e for e in sched.scale_events
               if e["to_shards"] < e["from_shards"]]
    # a pump rescales before it refills, so a request admitted at or after
    # the grow's pump (and before the shrink) went into a lane of the new
    # mesh; most finish within the pump that admitted them
    on_new = [r for r in reqs if grows and r.t_admit >= grows[0]["t"]
              and (not shrinks or r.t_admit < shrinks[0]["t"])]
    admitted_on_new = len(on_new)
    if not (grows and shrinks and admitted_on_new):
        raise AssertionError(f"(b): grows {len(grows)}, shrinks "
                             f"{len(shrinks)}, admitted on the new mesh "
                             f"{admitted_on_new}")
    if not all(r.result is not None and r.result.stats.certified
               for r in reqs):
        raise AssertionError("(b): a burst request was not served certified")
    if sig.unplanned:
        raise AssertionError(f"(b): unplanned signatures {sig.unplanned}")
    res_b = torch.as_tensor(np.stack([r.result.ids for r in reqs]),
                            device=device)
    assert_results(torch, sim, torch.as_tensor(rows, device=device),
                   res_b, torch.as_tensor(np.stack(
                       [r.result.scores for r in reqs])), eps, "(b) burst")
    qps_before, qps_after = burst_qps(reqs, t_burst, grows[0]["t"])
    st = db.stats()
    out["b_burst"] = dict(
        queries=nq, wall_s=t_end - t_burst, qps=nq / (t_end - t_burst),
        qps_before_grow=qps_before, qps_after_grow=qps_after,
        p50_latency_s=st["p50_latency"], p99_latency_s=st["p99_latency"],
        scale_events=[{k: e[k] for k in ("from_shards", "to_shards",
                                          "pause_s", "pending", "inflight")}
                      for e in sched.scale_events],
        admitted_on_new_mesh=admitted_on_new,
        admitted_to_new_lanes=sum(r.lane >= EL_LANES for r in on_new),
        certified_share=1.0,
        unplanned_signatures=len(sig.unplanned), shards_after=st["shards"])
    log("phase 8 (b) burst: a grow, a shrink, admitted on the new mesh, "
        "every request certified, no unplanned signature: "
        + json.dumps(out["b_burst"]))

    # (c) writes, then a background rebuild of the sharded epoch while a
    # burst grows the mesh: the swap reshards the rebuilt epoch
    snaps = {db.index.version: (db.index.n_total, db.index.deleted.copy())}
    new = deep_like(torch, FD_UPSERTS, D, seed, device,
                    row_seed=seed + 800).cpu().numpy()
    db.upsert(new)
    snaps[db.index.version] = (db.index.n_total, db.index.deleted.copy())
    dead: list[int] = []
    for r in reqs:
        for j in r.result.ids.tolist():
            if j >= 0 and j not in dead and len(dead) < FD_DELETES:
                dead.append(j)
    db.delete(dead)
    snaps[db.index.version] = (db.index.n_total, db.index.deleted.copy())
    path.bank()
    marks: dict = {}
    build = db.index._build

    def timed_build(snap):
        t = time.perf_counter()
        art = build(snap)
        torch.cuda.synchronize()
        marks["build_s"] = time.perf_counter() - t
        marks["shards_built"] = art.num_shards
        marks["ready"] = sched.clock()
        return art

    swap = db.backend.maybe_swap

    def timed_swap():
        t = time.perf_counter()
        ok = swap()
        if ok:
            torch.cuda.synchronize()
            marks["swap_s"] = time.perf_counter() - t
            marks["swapped"] = sched.clock()
        return ok

    reshard = StageTimer(torch)
    reshard.wrap(ssearch, "reshard_index", "reshard")
    db.index._build = timed_build
    db.backend.maybe_swap = timed_swap
    # idle pumps through the shrink's cooldown, so the burst below grows
    # the mesh within its first pumps, while the build runs
    for _ in range(EL_POLICY["cooldown"]):
        sched.pump()
    events0 = len(sched.scale_events)
    t_rebuild = sched.clock()
    db.rebuild(wait=False)
    # the rebuild pads the corpus to the larger target (tombstoned rows)
    snaps[db.index.version] = (db.index.n_total, db.index.deleted.copy())
    reqs_c, tags_c, fronts_c = serve_polled(sched, db.backend, db.index,
                                            queries)
    db.index.wait_rebuild()
    sched.drain()
    db.backend.maybe_swap()
    fresh = deep_like(torch, FD_AFTER_SWAP, D, seed, device,
                      row_seed=seed + 801).cpu().numpy()
    reqs_f, tags_f, fronts_f = serve_polled(
        sched, db.backend, db.index, [Query(v, k=K, eps=eps) for v in fresh])
    reshard.restore()
    path.bank()
    during = [e for e in sched.scale_events[events0:]
              if t_rebuild <= e["t"] <= marks.get("ready", -1.0)]
    if not (db.backend.swaps == 1 and db.backend.reshards == 1 and during
            and marks.get("shards_built") != db.backend.num_shards):
        raise AssertionError(
            f"(c): swaps {db.backend.swaps}, reshards {db.backend.reshards}, "
            f"scale events during the rebuild {len(during)}, built for "
            f"{marks.get('shards_built')} shards, serving "
            f"{db.backend.num_shards}")
    res_c = [r.result for r in reqs_c + reqs_f]
    tags = dict(tags_c)
    tags.update({len(reqs_c) + j: t for j, t in tags_f.items()})
    fronts = dict(fronts_c)
    fronts.update({len(reqs_c) + j: f for j, f in fronts_f.items()})
    check_valid_at_tag(res_c, tags, snaps, "(c)")
    certified_c = 0
    for j, r in enumerate(res_c):
        if set(dead) & set(r.ids.tolist()):
            raise AssertionError(f"(c) request {j}: a deleted id is served")
        if not r.stats.certified:
            continue
        certified_c += 1
        n_at = snaps[max(v for v in snaps if v <= tags[j][1])][0]
        ok, sel = theorems.theorem2_recheck(
            db.index.float_view()[:n_at], "l2", fronts[j][0], fronts[j][1],
            eps, K, device=device)
        if not (ok and np.array_equal(sel, r.ids)):
            raise AssertionError(f"(c) request {j}: the certificate fails "
                                 "theorem2_recheck over its corpus")
    path.drop()
    epochs = sorted({t[0] for t in tags.values()})
    if epochs != [0, 1]:
        raise AssertionError(f"(c): results from epochs {epochs}")
    out["c"] = dict(
        upserts=FD_UPSERTS, deletes=len(dead), rows=db.index.n_total,
        rebuild_s=marks["build_s"], shards_built=marks["shards_built"],
        reshard_s=reshard.seconds.get("reshard"), swap_s=marks["swap_s"],
        swap_drain_s=marks["swapped"] - marks["ready"],
        scale_events_during_rebuild=[(e["from_shards"], e["to_shards"])
                                     for e in during],
        served_while_building=nq, served_after_swap=FD_AFTER_SWAP,
        epochs_served=epochs, epoch_swaps=db.backend.swaps,
        reshards_at_swap=db.backend.reshards,
        certified_share=certified_c / len(res_c),
        shards_after=db.backend.num_shards)
    log("phase 8 (c) writes + rebuild with a rescale during it: every result "
        "valid at its tag, nothing deleted served, every certificate "
        "re-proved, one resharded swap: " + json.dumps(out["c"]))
    return out, path.total


def elastic_path(torch, report, db6, x_np, qs_np, eps, served6, seed,
                 device):
    """Phase 8: the sharded facade (a) and elastic rescaling (b), (c).
    Returns the path's launches of every kernel."""
    t_path = time.perf_counter()
    out, launches = sharded_facade(torch, db6, qs_np, eps, served6)
    out = dict(a=out)
    rec, more = elastic(torch, report, x_np, qs_np, eps, seed, device)
    out.update(rec)
    launches = {k: launches[k] + more[k] for k in launches}
    out["path_s"] = time.perf_counter() - t_path
    out["launches"] = {k: launches[k] for k in PATH8_KERNELS}
    missing = [k for k in PATH8_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the sharded facade "
                             f"and the elastic path: {missing}")
    report["elastic"] = out
    log("phase 8: " + json.dumps({k: out[k] for k in ("path_s",
                                                        "launches")}))
    return launches


# ------------------------------------------------------------- phase 9 ----

class ShapedLaunches(PathLaunches):
    """``PathLaunches`` that also keeps each kernel's launches by (lanes,
    width): the wrappers in ``kernels.ops``'s namespace are wrapped while it
    is installed, each call noted under the shape its kernel launches at
    (adjacency: ids [G, W]; greedy: scores [B, W]; sim_many: queries x rows;
    sim_gather: ids [B, M]). ``bank()`` keeps the noted shapes, ``drop()``
    forgets them; ``restore()`` puts the wrappers back."""

    SHAPES = {"pairwise_adjacency": ("adjacency_cuda", lambda a: a[1].shape),
              "greedy_diversify": ("greedy_cuda", lambda a: a[0].shape),
              "batch_similarity_many": (
                  "sim_many_cuda", lambda a: (a[0].shape[0], a[1].shape[0])),
              "batch_similarity_gather": ("sim_gather_cuda",
                                          lambda a: a[2].shape)}

    def __init__(self, ops):
        super().__init__(ops)
        self.hist = {name: {} for name in self.SHAPES}
        self._pending: list = []
        self._orig = {}
        for name, (attr, shape) in self.SHAPES.items():
            fn = getattr(ops, attr)
            self._orig[attr] = fn

            def noted(*a, _fn=fn, _name=name, _shape=shape, **kw):
                self._pending.append((_name, "%d x %d" % tuple(_shape(a))))
                return _fn(*a, **kw)

            setattr(ops, attr, noted)

    def bank(self):
        super().bank()
        for name, key in self._pending:
            self.hist[name][key] = self.hist[name].get(key, 0) + 1
        self._pending.clear()

    def drop(self):
        super().drop()
        self._pending.clear()

    def restore(self):
        for attr, fn in self._orig.items():
            setattr(self.ops, attr, fn)


def check_diverse(torch, sim, x, results, eps, what, diverse=True):
    """Every result distinct and valid, and diverse unless ``diverse`` is
    False (``assert_results``), with k ids unless it is exhausted (PDS:
    N/A). Returns the pairs above eps."""
    ids = torch.as_tensor(np.stack([r.ids for r in results]), device=x.device)
    scores = torch.as_tensor(np.stack([r.scores for r in results]),
                             device=x.device)
    assert_results(torch, sim, x, ids, scores, eps if diverse else math.inf,
                   what)
    short = [i for i, r in enumerate(results)
             if (r.ids >= 0).sum() < K and not r.stats.exhausted]
    if short:
        raise AssertionError(f"{what}: fewer than k = {K} ids in results "
                             f"{short}, none of them exhausted")
    return pairs_above(torch, sim, x, ids, eps)


def same_result(what, got_ids, got_scores, want_ids, want_scores,
                got_stats=None, want_stats=None, fields=()):
    """Equal ids, equal score bits and equal stats ``fields``."""
    got_scores = np.asarray(got_scores, np.float32)
    want_scores = np.asarray(want_scores, np.float32)
    if not (np.array_equal(got_ids, want_ids) and np.array_equal(
            got_scores.view(np.int32), want_scores.view(np.int32))):
        raise AssertionError(f"{what}: ids or score bits differ:\n"
                             f"{got_ids} {got_scores}\n{want_ids} "
                             f"{want_scores}")
    for f in fields:
        if getattr(got_stats, f) != getattr(want_stats, f):
            raise AssertionError(f"{what}: {f} {getattr(got_stats, f)} != "
                                 f"{getattr(want_stats, f)}")


def diverse_recall(result_ids, truth_ids) -> float:
    """benchmarks/common.py:22's recall of a diverse result against the
    oracle's ids."""
    a = {int(i) for i in result_ids if i >= 0}
    b = {int(i) for i in truth_ids if i >= 0}
    return 1.0 if not b else len(a & b) / len(b)


def method_summary(results, walls, oracle) -> dict:
    lat = sorted(walls)
    Ks = [int(r.stats.K_final) for r in results]
    return dict(
        wall_p50_s=lat[len(lat) // 2], wall_mean_s=float(np.mean(walls)),
        mean_total=float(np.mean([r.total for r in results])),
        recall=float(np.mean([diverse_recall(r.ids, o.ids)
                              for r, o in zip(results, oracle)])),
        K_final_mean=float(np.mean(Ks)), K_final_max=max(Ks),
        certified_share=float(np.mean([r.stats.certified for r in results])),
        exhausted=int(sum(r.stats.exhausted for r in results)),
        walls_s=list(walls), K_final=Ks)


def per_query_path(torch, report, graph, qs_np, eps, served4, q9=Q9,
                   pds_queries=PDS_QUERIES):
    """Phase 9: the paper's per-query API and its baselines on phase 4's
    graph and eps, over its first ``q9`` queries (PDS over the first
    ``pds_queries``). Returns the path's launches of every kernel and its
    launches by (lanes, width)."""
    from repro_torch.core import api, baselines, batch
    from repro_torch.core import batch_progressive as tbp
    from repro_torch.core import similarity as sim
    from repro_torch.kernels import ops

    t_path = time.perf_counter()
    if (q9, pds_queries) != (8, 8):
        report.setdefault("reduced", []).append(
            f"phase 9 runs {q9} queries, PDS {pds_queries} of them: at 8 "
            "queries each it took 626 s (NVIDIA H100 80GB HBM3, 700 W), 350 s "
            "of it PDS (7 of 8 N/A at max_K = 1024) and ~200 s its "
            "batch_pds check")
    if PDS_MAX_K != TABLE2_MAX_K:
        report.setdefault("reduced", []).append(
            f"phase 9's PDS runs at max_K = {PDS_MAX_K}, not "
            f"benchmarks/table2.py's {TABLE2_MAX_K}: at {TABLE2_MAX_K} its "
            "one query took 83.0 s (N/A) and its batch_pds check ~100 s of "
            "a 1 501 s script (NVIDIA H100 80GB HBM3, 700 W)")
    x = graph.vectors
    qs = qs_np[:q9]
    pl = ShapedLaunches(ops)
    results: dict = {}
    walls: dict = {}
    parts: dict = {}

    def run(method, fn, queries=qs):
        res, wall = [], []
        for q in queries:
            r, s = synced(torch, lambda: fn(q))
            res.append(r)
            wall.append(s)
        pl.bank()
        results[method], walls[method] = res, wall
        log(f"phase 9 {method}: {sum(wall):.2f} s for {len(queries)} "
            "queries")

    try:
        # (a) Alg. 2-4, one query at a time
        t = time.perf_counter()
        for m in PER_QUERY_METHODS:
            kw = dict(max_K=PDS_MAX_K) if m == "pds" else {}
            run(m, lambda q, m=m, kw=kw: api.diverse_search(
                graph, q, K, eps, method=m, ef=EF, **kw),
                qs[:pds_queries] if m == "pds" else qs)
        parts["a_per_query_s"] = time.perf_counter() - t
        # the per-query drivers against the batched engine's lanes
        t = time.perf_counter()
        for i, (r, w) in enumerate(zip(results["pss"], served4)):
            same_result(f"pss query {i} against phase 4's served result",
                        r.ids, r.scores, w.ids, w.scores, r.stats, w.stats,
                        ("certified", "exhausted", "K_final", "growths"))
        lock, _, lock_K = tbp.batch_pgs(graph, qs, K, eps, ef=EF)
        for i, r in enumerate(results["pgs"]):
            same_result(f"pgs query {i} against batch_pgs", r.ids, r.scores,
                        lock.ids[i], lock.scores[i])
            if int(r.stats.K_final) != int(lock_K[i]):
                raise AssertionError(f"pgs query {i}: K {r.stats.K_final} "
                                     f"!= batch_pgs's {lock_K[i]}")
        lock = tbp.batch_pds(graph, qs[:pds_queries], K, eps, ef=EF,
                             max_K=PDS_MAX_K)
        for i, r in enumerate(results["pds"]):
            same_result(f"pds query {i} against batch_pds", r.ids, r.scores,
                        lock.ids[i], lock.scores[i], r.stats,
                        lock.stats.lane_view(i),
                        ("certified", "exhausted", "K_final"))
        pl.drop()
        parts["a_engine_checks_s"] = time.perf_counter() - t

        # (b) the baselines and the ground truth on the same queries
        t = time.perf_counter()
        run("greedy", lambda q: api.diverse_search(graph, q, K, eps,
                                                   method="greedy",
                                                   L=GREEDY_L))
        run("ip_greedy", lambda q: api.diverse_search(
            graph, q, K, eps, method="ip_greedy", lam=IPG_LAM, L=GREEDY_L))
        run("oracle", lambda q: baselines.div_astar_oracle(
            x, graph.metric, q, K, eps, X=ORACLE_X))
        parts["b_baselines_s"] = time.perf_counter() - t

        # (c) the batch baselines
        t = time.perf_counter()
        qs16 = qs_np[:BATCH_Q]
        bg, bg_s = synced(torch, lambda: batch.batch_greedy_diverse(
            graph, qs16, K, eps, L=BATCH_L))
        pl.bank()
        bo, bo_s = synced(torch, lambda: batch.batch_optimal_diverse(
            graph, qs16, K, eps, K=BATCH_K, ef=BATCH_EF))
        pl.bank()
        parts["c_batch_s"] = time.perf_counter() - t
        t = time.perf_counter()
        bg_ids, bg_sc = bg[0].cpu().numpy(), bg[1].cpu().numpy()
        for i, q in enumerate(qs16):
            one = baselines.greedy_fixed(graph, q, K, eps, L=BATCH_L)
            same_result(f"batch_greedy_diverse lane {i} against greedy_fixed",
                        bg_ids[i], bg_sc[i], one.ids, one.scores)
        pl.drop()
        parts["c_checks_s"] = time.perf_counter() - t
    finally:
        pl.restore()

    # IP-greedy trades relevance against distance (Eq. 2) and takes no eps:
    # its pairs above eps are counted, not refused
    t = time.perf_counter()
    above = {method: check_diverse(torch, sim, x, res, eps,
                                   f"phase 9 {method}",
                                   diverse=method != "ip_greedy")
             for method, res in results.items()}
    for what, ids, sc in (("batch_greedy_diverse", bg[0], bg[1]),
                          ("batch_optimal_diverse", bo[0], bo[1])):
        assert_results(torch, sim, x, ids, sc, eps, what)
        if bool(((ids >= 0).sum(1) < K).any()):
            raise AssertionError(f"{what}: a lane with fewer than k ids")
    parts["gates_s"] = time.perf_counter() - t

    oracle = results["oracle"]
    out = dict(queries=q9, pds_queries=pds_queries, k=K, ef=EF, eps=eps,
               pds_max_K=PDS_MAX_K,
               oracle_X0=ORACLE_X, greedy_L=GREEDY_L, ip_greedy_lam=IPG_LAM,
               methods={m: method_summary(results[m], walls[m], oracle)
                        for m in results},
               pds_na=int(sum(r.stats.exhausted for r in results["pds"])),
               ip_greedy_pairs_above_eps=above["ip_greedy"],
               oracle_X=[int(o.stats.K_final) for o in oracle],
               oracle_complete=[bool(o.stats.certified) for o in oracle],
               batch=dict(queries=BATCH_Q,
                          greedy=dict(L=BATCH_L, wall_s=bg_s),
                          optimal=dict(K=BATCH_K, ef=BATCH_EF, wall_s=bo_s,
                                       certified_share=float(
                                           bo[3].float().mean()))),
               part_s=parts, widths=pl.hist,
               launches={k: pl.total[k] for k in PATH9_KERNELS})
    missing = [k for k in PATH9_KERNELS if pl.total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the per-query path: "
                             f"{missing}")
    out["path_s"] = time.perf_counter() - t_path
    report["per_query"] = out
    log("phase 9: " + json.dumps({k: out[k] for k in (
        "path_s", "part_s", "methods", "pds_na", "ip_greedy_pairs_above_eps",
        "oracle_X", "batch", "launches")}))
    log("launches by (lanes x width), phase 9: " + json.dumps(pl.hist))
    return pl.total, pl.hist


def single_lane_widths(hist: dict, name: str) -> list[int]:
    """The most frequent single-lane width of kernel ``name`` (ties: the
    wider) and its widest, from phase 9's launches by (lanes, width)."""
    ones = {int(key.split(" x ")[1]): n for key, n in hist[name].items()
            if key.startswith("1 x ")}
    freq = max(ones, key=lambda w: (ones[w], w))
    return sorted({freq, max(ones)})


def time_phase9_shapes(torch, ops, sim, x, hist, seed, timings) -> dict:
    """The single-lane adjacency and greedy against their plain versions
    on tie-free prefixes at phase 9's most frequent single-lane width and
    its widest, and timed there beside their bounds; each goes into its
    kernels-line row as ``path9_shapes``."""
    out: dict = {"pairwise_adjacency": [], "greedy_diversify": []}
    for name, primary in (("pairwise_adjacency", "adjacency_kernel"),
                          ("greedy_diversify", "greedy_")):
        for W in single_lane_widths(hist, name):
            ids, scores, _, eps = tie_free_prefixes(torch, sim, x, 1, W,
                                                    "l2", seed + W, x.device)
            valid = ids[0] >= 0
            rows = x[ids[0].clamp(min=0).long()]
            adj = ops.pairwise_adjacency(rows, eps[0], "l2", valid,
                                         impl="ref")
            if name == "pairwise_adjacency":
                fn_k = lambda: ops.pairwise_adjacency(rows, eps[0], "l2",
                                                      valid, impl="cuda")
                fn_p = lambda: ops.pairwise_adjacency(rows, eps[0], "l2",
                                                      valid, impl="ref")
                work = adjacency_work(ids, x.shape[1])
                got, want = fn_k(), adj
                same = torch.equal(got, want)
            else:
                fn_k = lambda: ops.greedy_diversify(scores[0], adj, K, valid,
                                                    impl="cuda")
                fn_p = lambda: ops.greedy_diversify(scores[0], adj, K, valid,
                                                    impl="ref")
                got, want = fn_k(), fn_p()
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                work = greedy_work(scores, valid[None], want[1].long()[None],
                                   K)
            if not same:
                raise AssertionError(f"{name} differs from its plain "
                                     f"version at 1 x {W}")
            ms, pms = time_ms(torch, fn_k), time_ms(torch, fn_p, reps=5)
            dev_us, _, kept = device_us(torch, fn_k, primary)
            bms, by = bound_ms(*work)
            row = dict(lanes=1, width=W, ms=ms, plain_ms=pms, bound_ms=bms,
                       bound_by=by, device_us=dev_us, device_us_kept=kept,
                       host_us=host_us(ms, dev_us))
            if name == "greedy_diversify":
                row["dependent_steps"] = K
            out[name].append(row)
            log(f"time {name} at phase 9's 1 x {W}: kernel {ms:.4f} ms "
                f"(device {dev_us} us), plain {pms:.4f} ms, bound "
                f"{bms:.6f} ms ({by})")
        timings[name]["path9_shapes"] = out[name]
    return out


# ------------------------------------------------------------ phase 10 ----

def reachable_share(neighbors: np.ndarray, entry: int) -> float:
    """Share of the nodes reachable from ``entry`` along level-0 edges."""
    seen = np.zeros(neighbors.shape[0], bool)
    seen[entry] = True
    frontier = np.array([entry])
    while frontier.size:
        nb = neighbors[frontier].ravel()
        nb = np.unique(nb[nb >= 0])
        nb = nb[~seen[nb]]
        seen[nb] = True
        frontier = nb
    return float(seen.mean())


def recall_at(ids, truth, k: int) -> float:
    """Mean overlap of each row's first k ids with the exact top-k."""
    return float(np.mean([len(set(ids[r, :k].tolist())
                              & set(truth[r, :k].tolist())) / k
                          for r in range(len(truth))]))


def mean_ms(timer: StageTimer, stage: str) -> float | None:
    n = timer.calls.get(stage, 0)
    return timer.seconds[stage] / n * 1e3 if n else None


def req_latency(r) -> float:
    return r.t_done - r.t_submit


def hnsw_build(torch, hnsw, flat, x_np, device) -> tuple[dict, dict]:
    """Phase 10 (a): the HNSW and KNN graphs of ``x_np`` on the card, with
    their gates. Returns ({"hnsw": graph, "knn": graph}, the record)."""
    n = x_np.shape[0]
    t0 = time.perf_counter()
    builder = hnsw.HNSWBuilder(x_np, "l2", M10, EFC10, 0, device)
    hg = builder.build()
    torch.cuda.synchronize()
    h_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kg = flat.build_knn_graph(x_np, "l2", M=M_GRAPH, device=device)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    for name, a in (("neighbors", hg.neighbors), ("upper", hg.upper),
                    ("knn neighbors", kg.neighbors)):
        if bool(((a < -1) | (a >= n)).any()):
            raise AssertionError(f"HNSW {name}: an id outside [-1, {n})")
    levels, top = builder.levels, builder.max_level
    if hg.num_upper_levels < 1:
        raise AssertionError("the HNSW graph has no upper level")
    if int(levels[hg.entry]) != top:
        raise AssertionError(f"the HNSW entry {hg.entry} is not a node of "
                             f"the top level {top}")
    rec = dict(
        rows=n, hnsw=dict(
            M=M10, ef_construction=EFC10, seed=0, build_s=h_s,
            ms_per_insert=h_s / n * 1e3, levels=top + 1,
            nodes_per_level=[int((levels >= lv).sum())
                             for lv in range(top + 1)],
            entry=int(hg.entry), upper_shape=list(hg.upper.shape),
            reachable_share=reachable_share(hg.neighbors.cpu().numpy(),
                                            hg.entry)),
        knn=dict(M=M_GRAPH, build_s=k_s, ms_per_row=k_s / n * 1e3,
                 reachable_share=reachable_share(kg.neighbors.cpu().numpy(),
                                                 kg.entry)))
    return {"hnsw": hg, "knn": kg}, rec


def hnsw_engine(torch, tbp, bs, sim, LaneRequest, graph, qs_np, eps, path,
                what):
    """Phase 10 (c) on one graph: the prewarmed 16-lane engine serves the
    queries, every result diverse, and the lockstep batch and the plain
    rerun must agree with it. Returns (served results, the record)."""
    timer = StageTimer(torch)
    timer.wrap(bs, "descend", "descend")
    try:
        engine = tbp.ProgressiveEngine(graph, num_lanes=LANES, max_k=K,
                                       default_ef=EF, kernel_impl="auto")
        engine.prewarm(max_capacity=1024, ks=(K,), widths=(64,))
        torch.cuda.synchronize()
        path.bank()
        timer.seconds.clear()
        timer.calls.clear()
        timer.wrap(engine, "admit", "admit")
        t0 = time.perf_counter()
        results, lat = serve(torch, engine, qs_np,
                             lambda q: LaneRequest(q, K, eps, ef=EF))
        total_s = time.perf_counter() - t0
        widths = launch_histogram(engine.signatures.counts,
                                  tbp.kops.launch_counts(),
                                  f"phase 10 (c) {what}")
        path.bank()
    finally:
        timer.restore()
    x = graph.vectors
    assert_results(torch, sim, x, torch.as_tensor(
        np.stack([r.ids for r in results]), device=x.device),
        torch.as_tensor(np.stack([r.scores for r in results]),
                        device=x.device), eps, f"phase 10 engine {what}")
    cert = np.array([bool(r.stats.certified) for r in results])
    check_s = {}
    for first, impl in ((LANES, "auto"), (RERUN10, "ref")):
        lock, check_s[impl] = synced(torch, lambda: tbp.batch_pss(
            graph, qs_np[:first], K, eps, ef=EF, kernel_impl=impl))
        got = np.stack([r.ids for r in results[:first]])
        if not (np.array_equal(lock.ids, got)
                and np.array_equal(lock.stats.certified, cert[:first])):
            raise AssertionError(f"phase 10 {what}: batch_pss "
                                 f"(kernel_impl={impl}) differs from the "
                                 "engine")
    path.drop()
    nq = len(qs_np)
    lat = sorted(lat)
    return results, dict(
        qps=nq / total_s, total_s=total_s, p50_s=lat[nq // 2],
        p99_s=lat[min(nq - 1, int(math.ceil(0.99 * nq)) - 1)],
        certified_share=float(cert.mean()),
        K_final_mean=float(np.mean([r.stats.K_final for r in results])),
        expansions_mean=float(np.mean([r.stats.expansions
                                       for r in results])),
        admits=timer.calls.get("admit", 0),
        admit_ms_mean=mean_ms(timer, "admit"),
        descends=timer.calls.get("descend", 0),
        descend_ms_mean=mean_ms(timer, "descend"),
        descend_s=timer.seconds.get("descend", 0.0),
        lockstep_s=check_s["auto"], plain_rerun_s=check_s["ref"],
        widths=widths)


def hnsw_facade(torch, rows, qs_np, eps, seed, device, path):
    """Phase 10 (e), the facade: an HNSW ``DiverseVectorDB`` over ``rows``
    serves queries bit-equal to a bare engine over its graph, takes writes,
    and rebuilds in the background while it serves."""
    from repro_torch.core import batch_progressive as tbp
    from repro_torch.core import theorems
    from repro_torch.core.backend import LaneRequest
    from repro_torch.db import DiverseVectorDB, Query

    out: dict = {}
    t0 = time.perf_counter()
    db = DiverseVectorDB(rows, "l2", builder="hnsw", num_lanes=LANES,
                         max_k=K, default_ef=EF, prewarm=False,
                         device=device)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["levels"] = db.index.graph.num_upper_levels + 1
    if db.index.graph.num_upper_levels < 1:
        raise AssertionError("facade: the HNSW graph has no upper level")
    qs16 = qs_np[:FD10_QUERIES]
    queries = [Query(q, k=K, eps=eps) for q in qs16]
    t0 = time.perf_counter()
    reqs_a, _, _ = serve_polled(db.scheduler, db.backend, db.index, queries)
    out["reads_s"] = time.perf_counter() - t0
    path.bank()
    bare = tbp.ProgressiveEngine(db.index.graph, num_lanes=LANES, max_k=K,
                                 default_ef=EF, kernel_impl="auto")
    want, _ = serve(torch, bare, qs16, lambda q: LaneRequest(q, K, eps,
                                                             ef=EF))
    for i, (r, w) in enumerate(zip(reqs_a, want)):
        same_result(f"facade read {i} against a bare engine", r.result.ids,
                    r.result.scores, w.ids, w.scores, r.result.stats,
                    w.stats, ("certified", "K_final"))
    path.drop()
    out["reads_p50_s"] = sorted(map(req_latency, reqs_a))[len(reqs_a) // 2]

    # writes, then a background rebuild while reads are served
    snaps = {db.index.version: (db.index.n_total, db.index.deleted.copy())}
    new = deep_like(torch, FD10_WRITES, D, seed, device,
                    row_seed=seed + 710).cpu().numpy()
    db.upsert(new)
    snaps[db.index.version] = (db.index.n_total, db.index.deleted.copy())
    dead: list[int] = []
    for r in reqs_a:
        for i in r.result.ids.tolist():
            if i >= 0 and i not in dead and len(dead) < FD10_WRITES:
                dead.append(i)
    db.delete(dead)
    snaps[db.index.version] = (db.index.n_total, db.index.deleted.copy())
    marks: dict = {}
    build = db.index._build

    def timed_build(snap):
        t = time.perf_counter()
        g = build(snap)
        torch.cuda.synchronize()
        marks["build_s"] = time.perf_counter() - t
        marks["ready"] = db.scheduler.clock()   # the requests' clock
        return g

    db.index._build = timed_build
    fresh = deep_like(torch, FD10_QUERIES * 4, D, seed, device,
                      row_seed=seed + 711).cpu().numpy()
    reqs, tags, fronts = [], {}, {}
    t0 = time.perf_counter()
    db.rebuild(wait=False)
    rounds = 0
    while "ready" not in marks and rounds < FD10_MAX_ROUNDS:
        part = fresh[(rounds % 4) * FD10_QUERIES:][:FD10_QUERIES]
        r_, t_, f_ = serve_polled(db.scheduler, db.backend, db.index,
                                  [Query(q, k=K, eps=eps) for q in part])
        tags.update({len(reqs) + i: t for i, t in t_.items()})
        fronts.update({len(reqs) + i: f for i, f in f_.items()})
        reqs += r_
        rounds += 1
    db.index.wait_rebuild()
    db.scheduler.drain()
    db.backend.maybe_swap()
    during = [r for r in reqs if r.t_done <= marks["ready"]]
    overlapped = [r for r in reqs if r.t_submit <= marks["ready"]]
    r_, t_, f_ = serve_polled(db.scheduler, db.backend, db.index,
                              [Query(q, k=K, eps=eps) for q in qs16])
    tags.update({len(reqs) + i: t for i, t in t_.items()})
    fronts.update({len(reqs) + i: f for i, f in f_.items()})
    reqs += r_
    path.bank()
    st = db.stats()
    if st["epoch_swaps"] != 1 or db.index.epoch != 1:
        raise AssertionError(f"facade: {st['epoch_swaps']} epoch swaps")
    if db.index.graph.num_upper_levels < 1:
        raise AssertionError("facade: the rebuilt graph has no upper level")
    results = [r.result for r in reqs]
    check_valid_at_tag(results, tags, snaps, "phase 10 facade")
    certified = 0
    for i, r in enumerate(results):
        if set(dead) & set(r.ids.tolist()):
            raise AssertionError(f"facade read {i}: a deleted id is served")
        if not r.stats.certified:
            continue
        certified += 1
        ok, sel = theorems.theorem2_recheck(
            db.index.float_view(), "l2", fronts[i][0], fronts[i][1], eps, K,
            device=device)
        if not (ok and np.array_equal(sel, r.ids)):
            raise AssertionError(f"facade read {i}: the certificate fails "
                                 "theorem2_recheck over the live corpus")
    path.drop()
    out.update(
        rebuild_s=marks["build_s"], rebuild_levels=(
            db.index.graph.num_upper_levels + 1),
        reads_done_while_rebuilding=len(during),
        reads_submitted_while_rebuilding=len(overlapped),
        their_p50_s=(sorted(map(req_latency, overlapped))[
            len(overlapped) // 2] if overlapped else None),
        reads_after_writes=len(results), certified_after_writes=certified,
        epochs_served=sorted({t[0] for t in tags.values()}),
        serve_and_swap_s=time.perf_counter() - t0, upserts=FD10_WRITES,
        deletes=len(dead))
    return out


def hnsw_sharded(torch, hnsw, ss, flat, sim, rows, qs_np, eps, device,
                 path):
    """Phase 10 (e), the sharded path over HNSW shard graphs."""
    from repro_torch import compat

    out: dict = {}
    rows_t = torch.as_tensor(rows, device=device)
    ns = len(rows) // FD10_SHARDS
    t0 = time.perf_counter()
    idx = ss.build_sharded_index(rows, FD10_SHARDS, "l2", M=16,
                                 builder="hnsw", device=device)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0

    def same_shard0(index, size, what):
        g = hnsw.build_hnsw(rows[:size], "l2", M=16, device=device)
        if not (torch.equal(index.neighbors[0], g.neighbors)
                and int(index.entries[0]) == g.entry):
            raise AssertionError(f"{what}: shard 0 is not build_hnsw's "
                                 f"level 0 of its {size} rows")

    same_shard0(idx, ns, "build_sharded_index")
    mesh = compat.make_mesh((FD10_SHARDS,), ("data",), device=device)
    q16 = torch.as_tensor(qs_np[:FD10_QUERIES], device=device)
    path.bank()
    (d_ids, d_sc, d_cert), out["diverse_s"] = synced(
        torch, lambda: ss.sharded_diverse_search(idx, rows_t, q16, K, eps,
                                                 SH_KDIV, mesh))
    (t_ids, _), out["topk_s"] = synced(
        torch, lambda: ss.sharded_topk(idx, q16, K, SH_L, mesh))
    path.bank()
    assert_results(torch, sim, rows_t, d_ids, d_sc, eps,
                   "phase 10 sharded_diverse_search")
    truth = flat.exact_topk(q16, rows_t, K, "l2", device=device)[0]
    out["topk_recall@10"] = recall_at(t_ids.cpu().numpy(), truth, K)
    out["diverse_certified_share"] = float(d_cert.float().mean())
    t0 = time.perf_counter()
    idx2 = ss.reshard_index(idx, 2, rows, builder="hnsw")
    torch.cuda.synchronize()
    out["reshard_s"] = time.perf_counter() - t0
    path.bank()
    same_shard0(idx2, len(rows) // 2, "reshard_index")
    path.drop()
    return out


def hnsw_path(torch, report, x_np, qs_np, seed, device):
    """Phase 10: the paper's index on phase 4's first rows ``x_np`` and its
    queries. Returns the path's launches of every kernel."""
    from repro_torch.core import similarity as sim
    from repro_torch.kernels import ops

    t_path = time.perf_counter()
    report.setdefault("reduced", []).append(
        f"phase 10 builds its HNSW graph over the first {len(x_np)} rows of "
        "phase 4's corpus, half the benchmarks' N_DEFAULT of 20 000 and not "
        "1M: the builder is host code, one insert at a time (4.36-4.62 ms "
        "an insert at 20 000 rows on H100 machines' hosts, more as the "
        "graph deepens: hours at 1M), and at 20 000 rows the whole script "
        "took 1 260.5 s (NVIDIA H100 80GB HBM3, 700 W), past its 1 200 s "
        f"limit; its facade, rebuild and shards run on the first "
        f"{FD10_ROWS} rows")
    report["reduced"].append(
        f"phase 10's engines serve {SERVED10} of the 64 queries (one wave "
        f"of the 16 lanes, all held to the lockstep batch), rerun "
        f"{RERUN10} on the plain versions, and the per-query API runs on "
        f"{Q10} queries: at 64 / 4 / 4 over 10 000 rows the whole script "
        "took 1 386.8 s (phases 1-9 799.3 s, phase 10 587.4 s; NVIDIA H100 "
        "80GB HBM3, 700 W), past its 1 200 s limit; at 16 / 2 / 2 phase 10 "
        "alone took 322.9 s (its plain reruns 87.6 s, the per-query API "
        "~25 s a query on the HNSW graph and ~11 s on the KNN graph), ~1 122 "
        "s with phases 1-9 before phase 11 was added; at eps of degree 100 "
        "over 10 000 rows a query takes ~6 500 expansions")
    out: dict = {}
    x = torch.as_tensor(x_np, device=device)
    qs = torch.as_tensor(qs_np, device=device)
    eps = calibrate_eps(torch, sim, x, seed + 1, device)
    path = ShapedLaunches(ops)
    try:
        hnsw_path_parts(torch, out, x_np, x, qs_np, qs, eps, seed, device,
                        path)
    finally:
        path.restore()
    out.update(rows=len(x_np), eps=eps, served=SERVED10, rerun=RERUN10,
               q10=Q10, path_s=time.perf_counter() - t_path,
               launches={k: path.total[k] for k in PATH10_KERNELS},
               widths=path.hist)
    missing = [k for k in PATH10_KERNELS if path.total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the HNSW path: "
                             f"{missing}")
    report["hnsw_path"] = out
    log("phase 10: " + json.dumps({k: out[k] for k in (
        "path_s", "launches")}))
    log("launches by (lanes x width), phase 10: " + json.dumps(path.hist))
    return path.total


def hnsw_path_parts(torch, out, x_np, x, qs_np, qs, eps, seed, device, path):
    """Phase 10 (a)-(e), their records into ``out``."""
    from repro_torch.core import api, baselines, batch
    from repro_torch.core import batch_progressive as tbp
    from repro_torch.core import beam_search as bs
    from repro_torch.core import similarity as sim
    from repro_torch.core.backend import LaneRequest
    from repro_torch.index import flat, hnsw
    from repro_torch.sharded_search import search as ss

    # (a) the two graphs
    graphs, out["a_build"] = hnsw_build(torch, hnsw, flat, x_np, device)
    path.bank()
    log("phase 10 (a) build: " + json.dumps(out["a_build"]))

    # (b) beam recall@10 against the exact top-10
    truth = flat.exact_topk(qs, x, K, "l2", device=device)[0]
    beam: dict = {}
    for name, widths in (("hnsw", BEAM_WIDER), ("knn", (BEAM_L,))):
        g = graphs[name]
        for L in widths:
            st, secs = synced(torch, lambda: bs.run_search(
                g, qs, bs.init_state(g, qs, L), stable_limit=L))
            steps = st.steps.cpu().numpy()
            beam[f"{name}_L{L}"] = dict(
                recall=recall_at(st.queue.ids.cpu().numpy(), truth, K),
                steps_mean=float(steps.mean()), steps_max=int(steps.max()),
                search_s=secs)
        ids_b, _ = batch.batch_beam_search(g, qs, K, BEAM_L)
        path.bank()
        st = bs.run_search(g, qs, bs.init_state(g, qs, BEAM_L),
                           stable_limit=BEAM_L)
        if not torch.equal(ids_b, st.queue.ids[:, :K]):
            raise AssertionError(f"phase 10 {name}: batch_beam_search "
                                 "differs from its loop")
        path.drop()
    out["b_beam"] = beam
    log("phase 10 (b) beam recall@10 (k = 10): " + json.dumps(beam))

    # (c) the 16-lane engine on both graphs
    served: dict = {}
    out["c_engine"] = {}
    for name in ("hnsw", "knn"):
        served[name], out["c_engine"][name] = hnsw_engine(
            torch, tbp, bs, sim, LaneRequest, graphs[name],
            qs_np[:SERVED10], eps, path, name)
        log(f"phase 10 (c) engine on the {name} graph (results diverse; "
            "lockstep and plain reruns agree): "
            + json.dumps(out["c_engine"][name]))

    # (d) the per-query API and the oracle on the first Q10 queries
    q10 = qs_np[:Q10]
    results: dict = {}
    walls: dict = {}
    runs = (("hnsw pss", graphs["hnsw"], dict(method="pss", ef=EF)),
            ("hnsw pgs", graphs["hnsw"], dict(method="pgs", ef=EF)),
            ("hnsw greedy", graphs["hnsw"], dict(method="greedy",
                                                 L=GREEDY_L)),
            ("knn pss", graphs["knn"], dict(method="pss", ef=EF)))
    for key, g, kw in runs:
        res, wall = [], []
        for q in q10:
            r, s = synced(torch, lambda: api.diverse_search(g, q, K, eps,
                                                            **kw))
            res.append(r)
            wall.append(s)
        results[key], walls[key] = res, wall
    res, wall = [], []
    for q in q10:
        r, s = synced(torch, lambda: baselines.div_astar_oracle(
            x, "l2", q, K, eps, X=ORACLE_X))
        res.append(r)
        wall.append(s)
    results["oracle"], walls["oracle"] = res, wall
    path.bank()
    for name in ("hnsw", "knn"):
        for i, (r, w) in enumerate(zip(results[f"{name} pss"],
                                       served[name])):
            same_result(f"phase 10 {name} pss query {i} against the "
                        "engine's served result", r.ids, r.scores, w.ids,
                        w.scores, r.stats, w.stats,
                        ("certified", "exhausted", "K_final", "growths"))
    for key, res in results.items():
        check_diverse(torch, sim, x, res, eps, f"phase 10 {key}")
    out["d_per_query"] = {key: method_summary(results[key], walls[key],
                                              results["oracle"])
                          for key in results}
    out["d_per_query"]["oracle_X"] = [int(o.stats.K_final)
                                      for o in results["oracle"]]
    log("phase 10 (d) per-query API (pss equal to the engine's served "
        "results): " + json.dumps(out["d_per_query"]))

    # (e) the facade, its writes and rebuild, and the sharded path
    rows = x_np[:FD10_ROWS]
    eps_fd = calibrate_eps(torch, sim, x[:FD10_ROWS], seed + 2, device)
    out["e_eps"] = eps_fd
    out["e_facade"] = hnsw_facade(torch, rows, qs_np, eps_fd, seed,
                                  device, path)
    log("phase 10 (e) facade (reads equal to a bare engine; after the "
        "swap no deleted id served, every certificate re-proved): "
        + json.dumps(out["e_facade"]))
    out["e_sharded"] = hnsw_sharded(torch, hnsw, ss, flat, sim, rows, qs_np,
                                    eps_fd, device, path)
    log("phase 10 (e) sharded (shard 0 equals build_hnsw's level 0, before "
        "and after the reshard): " + json.dumps(out["e_sharded"]))


# ------------------------------------------------------------ phase 11 ----

def bf16_tol(ref, ulps: int) -> float:
    """``ulps`` bf16 ulps of the largest |value| of ``ref``."""
    top = float(ref.abs().max())
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7)


def logit_gap(torch, got, want, ulps: int) -> dict:
    """The gap between ``got`` and ``want`` against ``ulps`` bf16 ulps of
    ``want``'s largest |logit|, and the argmax mismatches where ``want``'s
    top-2 margin exceeds twice that."""
    tol = bf16_tol(want, ulps)
    gap = float((got - want).abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * tol
    flips = int((got.argmax(-1) != want.argmax(-1))[sure].sum())
    return dict(max_abs_err=gap, tol=tol, ulps_of_largest=gap / (tol / ulps),
                tokens_compared_share=float(sure.float().mean()),
                token_mismatches=flips)


def compare_logits(torch, got, want, ulps: int, what: str) -> dict:
    """``got`` within ``ulps`` bf16 ulps of ``want``'s largest |logit|, and
    the argmax equal wherever ``want``'s top-2 margin exceeds twice that;
    returns the gap, the tolerance and the share of positions compared."""
    out = logit_gap(torch, got, want, ulps)
    if not out["max_abs_err"] <= out["tol"] or out["token_mismatches"]:
        raise AssertionError(f"{what}: {out}")
    return out


def decode_profile(torch, M, cfg, params, tokens, device) -> dict:
    """``RAG_PROFILE_STEPS`` decode steps at B = len(tokens): their synced
    wall, then the same steps under torch.profiler (device activity):
    kernel launches a step and the device's idle share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    def steps():
        cache = M.init_cache(cfg, tokens.shape[0], RAG_PROFILE_STEPS,
                             device=device)
        for t in range(RAG_PROFILE_STEPS):
            _, cache = M.decode_step(cfg, params, cache, tokens[:, t:t + 1])
        torch.cuda.synchronize()

    steps()
    t0 = time.perf_counter()
    steps()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steps()
    kernels = device_events(torch, prof)
    busy = sum(dur for _, dur in kernels) / 1e6
    by_name: dict[str, float] = {}
    for name, dur in kernels:
        by_name[name] = by_name.get(name, 0.0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(steps=RAG_PROFILE_STEPS, wall_s=wall,
                launches_per_step=len(kernels) / RAG_PROFILE_STEPS,
                device_busy_s=busy,
                device_idle_share=1.0 - busy / wall if busy else None,
                top_kernels_s=[(n[:80], us / 1e6) for n, us in top])


def rag_path(torch, report, graph, qs_np, eps, served4, seed, device):
    """Phase 11: the RAG serving path at qwen2-1.5b's full width on phase
    4's graph, eps, queries and served results. Returns the path's
    launches of every kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import similarity as sim
    from repro_torch.db import DiverseVectorDB
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.rag import RagPipeline

    t_path = time.perf_counter()
    out: dict = {}
    cfg = get_config(RAG_ARCH)

    # (a) the model: seeded random weights on the card
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed + 500), device=device)
    torch.cuda.synchronize()
    by_dtype: dict[str, int] = {}
    for p in params.parameters():
        key = str(p.dtype).removeprefix("torch.")
        by_dtype[key] = by_dtype.get(key, 0) + p.numel()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    out["a"] = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
                    parameters=by_dtype, weight_bytes=weight_bytes,
                    init_s=time.perf_counter() - t0)
    log("phase 11 (a) model: " + json.dumps(out["a"]))

    # (b) retrieval through the facade, then generation
    path = PathLaunches(ops)
    db = DiverseVectorDB(index=graph, metric="l2", num_lanes=LANES, max_k=K,
                         default_ef=EF, scheduler_kw=dict(
                             prewarm_capacity=1024, prewarm_ks=(K,),
                             prewarm_widths=(64,)), device=device)
    pipe = RagPipeline(cfg, params, db=db, k=K, eps=eps, ef=EF)
    prompts = np.random.default_rng(seed + 501).integers(
        0, cfg.vocab_size, (RAG_Q, RAG_PROMPT)).astype(np.int32)
    retrieve, decode = pipe.retrieve, M.decode_step
    walls: dict[str, float] = {}
    step_ms: list[float] = []
    step_logits: list = []

    def timed_retrieve(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = retrieve(*a, **kw)
        torch.cuda.synchronize()
        walls["retrieve_s"] = time.perf_counter() - t
        return res

    def timed_decode(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = decode(*a)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        step_logits.append(logits[:, 0])
        return logits, cache

    pipe.retrieve = timed_retrieve
    M.decode_step = timed_decode
    try:
        t0 = time.perf_counter()
        tokens, ids, cert = pipe.generate(qs_np[:RAG_Q], prompts,
                                          steps=RAG_STEPS)
        generate_s = time.perf_counter() - t0
    finally:
        M.decode_step = decode
        del pipe.retrieve
    path.bank()
    for i in range(RAG_Q):
        want = served4[i]
        if not (np.array_equal(ids[i], want.ids)
                and bool(cert[i]) == bool(want.stats.certified)):
            raise AssertionError(f"(b) query {i}: retrieved {ids[i]} "
                                 f"certified={cert[i]}, phase 4 served "
                                 f"{want.ids} certified="
                                 f"{want.stats.certified}")
    assert_results(torch, sim, graph.vectors, torch.as_tensor(
        ids, device=device), torch.as_tensor(np.stack(
            [served4[i].scores for i in range(RAG_Q)])), eps, "(b) RAG")
    if tokens.shape != (RAG_Q, RAG_STEPS) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"(b) tokens {tokens.shape}: out of range")
    decode_steps = len(step_ms)
    median_ms = float(np.median(step_ms))
    out["b"] = dict(
        queries=RAG_Q, prompt_tokens=RAG_PROMPT, steps=RAG_STEPS,
        retrieve_s=walls["retrieve_s"], qps=RAG_Q / walls["retrieve_s"],
        certified_share=float(np.mean(cert)), generate_s=generate_s,
        decode_steps=decode_steps, decode_ms_median=median_ms,
        decode_ms_min=min(step_ms), decode_ms_max=max(step_ms),
        decode_tokens_per_s=RAG_Q / (median_ms / 1e3),
        generated_tokens_per_s=RAG_Q * RAG_STEPS / (
            generate_s - walls["retrieve_s"]),
        weight_read_bound_ms=weight_bytes / PEAK_BYTES_PER_S * 1e3,
        bit_equal_to_phase4=True)
    log("phase 11 (b) retrieval equal to phase 4's served results, every "
        "row diverse; generation: " + json.dumps(out["b"]))

    # (c) 1. decode along the generated sequence against the forward pass
    seq = torch.cat([torch.remainder(torch.as_tensor(ids, dtype=torch.int64),
                                     cfg.vocab_size),
                     torch.as_tensor(prompts, dtype=torch.int64),
                     torch.as_tensor(tokens, dtype=torch.int64)],
                    dim=1).to(device)
    dec = torch.stack(step_logits, dim=1)
    del step_logits
    fwd, _ = M.forward(cfg, params, dict(tokens=seq[:, :decode_steps]))
    out["c_forward"] = compare_logits(torch, dec, fwd, RAG_FWD_ULPS,
                                      "(c) decode against forward")
    del dec, fwd
    log("phase 11 (c) decode logits against the forward pass at full "
        "width: " + json.dumps(out["c_forward"]))

    # (c) 2. two layers at full width: the card against the plain CPU
    cfg2 = dataclasses.replace(cfg, num_layers=RAG_CPU_LAYERS)
    p2 = M.init_params(cfg2, torch.Generator(device=device).manual_seed(
        seed + 502), device=device)
    p2_cpu = M.from_host(cfg2, M.to_host(p2), device="cpu")
    got, want = [], []
    for params_, dev_, into in ((p2, device, got), (p2_cpu, "cpu", want)):
        cache = M.init_cache(cfg2, RAG_Q, RAG_CPU_STEPS, device=dev_)
        for t in range(RAG_CPU_STEPS):
            logits, cache = M.decode_step(cfg2, params_, cache,
                                          seq[:, t:t + 1].to(dev_))
            into.append(logits[:, 0].cpu())
    out["c_cpu"] = compare_logits(torch, torch.stack(got, 1),
                                  torch.stack(want, 1), RAG_LOGIT_ULPS,
                                  "(c) card against the CPU")
    out["c_cpu"]["layers"] = RAG_CPU_LAYERS
    del p2, p2_cpu
    log(f"phase 11 (c) {RAG_CPU_LAYERS} layers at full width, "
        f"{RAG_CPU_STEPS} decode steps, the card against the plain CPU: "
        + json.dumps(out["c_cpu"]))

    # (d) launches a decode step and the device's idle share
    out["d"] = decode_profile(torch, M, cfg, params, seq, device)
    log("phase 11 (d) decode steps profiled: " + json.dumps(out["d"]))
    path.drop()
    mem_before = torch.cuda.memory_allocated()
    del pipe, params, db, retrieve
    gc.collect()
    torch.cuda.empty_cache()
    out["freed_bytes"] = mem_before - torch.cuda.memory_allocated()
    out["path_s"] = time.perf_counter() - t_path
    out["launches"] = dict(path.total)
    missing = [k for k in PATH11_KERNELS if path.total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the RAG path: "
                             f"{missing}")
    report["rag_path"] = out
    log("phase 11: " + json.dumps({k: out[k] for k in ("path_s",
                                                        "launches")}))
    return path.total


# ------------------------------------------------------------ phase 12 ----

def step_read_bytes(cfg, params, cache) -> int:
    """The bytes one decode step must move: every parameter it reads (not
    an untied embedding table, of which it gathers B rows, nor encdec's
    learned positions and encoder, nor vlm's cross k / v projections,
    whose output the cache holds), each cache tensor read once and the
    recurrent states (ssm's, hybrid's) written once."""
    head_is_embed = cfg.tie_embeddings or cfg.family == "encdec"
    total = 0
    for name, p in params.named_parameters():
        if (name.startswith(("enc_blocks.", "enc_ln.", "dec_pos"))
                or (name == "embed" and not head_is_embed)
                or (name.startswith("cross_blocks.")
                    and name.endswith(("attn.wk", "attn.wv")))):
            continue
        total += p.numel() * p.element_size()
    for key, t in cache.items():
        written = key in ("conv", "h", "lru_h") or key.endswith(("_h",
                                                                 "_conv"))
        total += t.numel() * t.element_size() * (2 if written else 1)
    return total


class RouteLog:
    """Records the experts each ``moe.route`` call picks, or, with
    ``replay`` set, makes each call take the recorded experts instead (its
    gates renormalised over them from this run's router probabilities, its
    ranks recomputed) and counts the routes whose own top-k would have
    differed."""

    def __init__(self, moe):
        self.moe, self.real = moe, moe.route
        self.log: list = []
        self.replay: list | None = None
        self.flips = self.routes = 0

    def __enter__(self):
        self.moe.route = self.route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real

    def route(self, router_w, xt, num_experts, experts_per_token,
              capacity_factor):
        probs, gate, expert, *rest = self.real(
            router_w, xt, num_experts, experts_per_token, capacity_factor)
        if self.replay is None:
            self.log.append(expert)
            return (probs, gate, expert, *rest)
        forced = self.replay.pop(0).to(expert.device)
        self.flips += int((forced.sort(-1).values != expert.sort(-1).values)
                          .any(-1).sum())
        self.routes += forced.shape[0]
        gate = probs.gather(1, forced)
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
        return (probs, gate, forced,
                *self.moe.ranks(forced, num_experts, capacity_factor))

    def decode_as_forward(self, torch, layers: int, batch: int) -> list:
        """The log of ``steps`` decode steps over ``layers`` moe layers
        (step-major) as a forward pass's calls: one [batch * steps, topk]
        per layer, tokens batch-major."""
        steps = len(self.log) // layers
        return [torch.stack([self.log[t * layers + l] for t in range(steps)],
                            1).reshape(batch * steps, -1)
                for l in range(layers)]


def family_decode(torch, M, cfg, params, seq, steps, device, fill=None):
    """``steps`` decode steps of ``seq`` from a fresh cache (its cross k / v
    copied from ``fill`` where given): the logits [B, steps, V]."""
    cache = M.init_cache(cfg, seq.shape[0], steps, device=device)
    for key, t in (fill or {}).items():
        cache[key].copy_(t)
    out = []
    for t in range(steps):
        logits, cache = M.decode_step(cfg, params, cache,
                                      seq[:, t:t + 1].to(device))
        out.append(logits[:, 0])
    return torch.stack(out, 1)


def decode_against_forward(torch, M, cfg, params, seq, served_logits, seed,
                           device) -> dict:
    """(d) 1: decode along ``seq`` against the forward pass on it. ssm,
    hybrid and vlm as served (vlm's zero gates add exactly 0 in both); moe
    at capacity_factor = E / topk, where no pair drops (the served capacity
    drops different pairs in the two paths), its forward compared freely
    (tokens, route flips) and, for the logits, with the decode's routes
    replayed; encdec with its cross cache filled from the encoder's output
    of seeded frames."""
    import dataclasses

    from repro_torch.models import encdec
    from repro_torch.models import moe

    n = served_logits.shape[1]
    batch = dict(tokens=seq[:, :n])
    dec = served_logits
    gen = torch.Generator(device=device).manual_seed(seed)
    what = f"(d) {cfg.name} decode against forward"
    if cfg.num_frontend_tokens:
        batch["frontend_embeds"] = (torch.randn(
            (seq.shape[0], cfg.num_frontend_tokens, cfg.d_model),
            generator=gen, device=device) * 0.5).to(torch.bfloat16)
    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
        for t in (seq.shape[0], seq.shape[0] * n):
            cap = int(t * cfg.experts_per_token * cfg.capacity_factor
                      / cfg.num_experts)
            if cap < t:
                raise AssertionError(f"(d) capacity {cap} < {t} tokens")
        with RouteLog(moe) as dec_routes:
            dec = family_decode(torch, M, cfg, params, seq, n, device)
        free, _ = M.forward(cfg, params, batch)
        free_out = logit_gap(torch, dec, free, FAM_FWD_ULPS[cfg.family])
        del free
        with RouteLog(moe) as fwd_routes:
            fwd_routes.replay = dec_routes.decode_as_forward(
                torch, cfg.num_layers, seq.shape[0])
            fwd, _ = M.forward(cfg, params, batch)
        out = compare_logits(torch, dec, fwd, FAM_FWD_ULPS[cfg.family],
                             what + " (decode's routes replayed)")
        out.update(free_ulps_of_largest=free_out["ulps_of_largest"],
                   free_token_mismatches=free_out["token_mismatches"],
                   route_flips=fwd_routes.flips, routes=fwd_routes.routes,
                   route_flip_share=fwd_routes.flips / fwd_routes.routes)
        out["steps"] = n
        return out
    if cfg.family == "encdec":
        enc = encdec.encode(cfg, params, batch["frontend_embeds"])
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        fill = {key: torch.stack([
            encdec._project(getattr(p.cross_attn, w), getattr(p.cross_attn, b),
                            enc, kv, hd) for p in params.dec_blocks])
            for key, w, b in (("cross_k", "wk", "bk"),
                              ("cross_v", "wv", "bv"))}
        dec = family_decode(torch, M, cfg, params, seq, n, device, fill)
        del enc, fill
    fwd, _ = M.forward(cfg, params, batch)
    out = compare_logits(torch, dec, fwd, FAM_FWD_ULPS[cfg.family], what)
    out["steps"] = n
    return out


def card_against_cpu(torch, M, cfg, seq, seed, device) -> dict:
    """(d) 2: at the least depth that holds each of the family's block
    kinds once, FAM_CPU_STEPS decode steps on the card against the plain
    CPU on the same parameters (vlm's gates at 0.5, encdec's and vlm's
    cross caches seeded, so that the cross-attention contributes; moe with
    the card's routes replayed on the CPU, the flips counted)."""
    import dataclasses

    from repro_torch.models import moe

    cfg = dataclasses.replace(cfg, **FAM_CHECK_DEPTH[cfg.family])
    steps = FAM_CPU_STEPS[cfg.family]
    t0 = time.perf_counter()
    card = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device=device)
    for blk in getattr(card, "cross_blocks", ()):
        blk.gate.fill_(0.5)
    cpu = M.abstract_params(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()},
                        assign=True)
    shapes = M.init_cache(cfg, seq.shape[0], steps, device="meta")
    gen = torch.Generator().manual_seed(seed)
    fill = {key: torch.randn(shapes[key].shape, generator=gen).to(
        shapes[key].dtype) for key in ("cross_k", "cross_v") if key in shapes}
    with RouteLog(moe) as routes:
        got = family_decode(torch, M, cfg, card, seq, steps, device, {
            k: v.to(device) for k, v in fill.items()}).cpu()
        del card
        t1 = time.perf_counter()
        routes.replay = routes.log
        want = family_decode(torch, M, cfg, cpu, seq.cpu(), steps, "cpu",
                             fill)
    out = compare_logits(torch, got, want, RAG_LOGIT_ULPS,
                         f"(d) {cfg.name} card against the CPU")
    out.update(layers=cfg.num_layers, encoder_layers=cfg.encoder_layers,
               steps=steps, cpu_s=time.perf_counter() - t1,
               s=time.perf_counter() - t0)
    if routes.routes:
        out.update(route_flips=routes.flips, routes=routes.routes)
    return out


def families_path(torch, report, graph, qs_np, eps, served4, seed, device):
    """Phase 12: one arch of each other family at full width (vlm at
    FAM_VLM_LAYERS) served through ``RagPipeline`` on one cached facade
    over phase 4's graph; phase 4's eps, queries and served results.
    Returns the path's launches of every kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import similarity as sim
    from repro_torch.db import DiverseVectorDB
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.rag import RagPipeline

    t_path = time.perf_counter()
    out: dict = {"families": {}}
    path = PathLaunches(ops)
    db = DiverseVectorDB(index=graph, metric="l2", num_lanes=LANES, max_k=K,
                         default_ef=EF, cache_size=FAM_CACHE, scheduler_kw=dict(
                             prewarm_capacity=1024, prewarm_ks=(K,),
                             prewarm_widths=(64,)), device=device)
    path.bank()
    prompts = np.random.default_rng(seed + 601).integers(
        0, 1 << 30, (RAG_Q, RAG_PROMPT)).astype(np.int64)
    served_ids = np.stack([served4[i].ids for i in range(RAG_Q)])
    served_scores = torch.as_tensor(np.stack(
        [served4[i].scores for i in range(RAG_Q)]))
    for i, name in enumerate(FAM_ARCHS):
        t_fam = time.perf_counter()
        cfg = get_config(name)
        if cfg.family == "vlm":
            cfg = dataclasses.replace(cfg, num_layers=FAM_VLM_LAYERS)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # (a) the model: seeded random weights on the card
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(
            device=device).manual_seed(seed + 600 + i), device=device)
        torch.cuda.synchronize()
        fam = dict(arch=cfg.name, family=cfg.family, layers=cfg.num_layers,
                   init_s=time.perf_counter() - t0,
                   parameters=sum(p.numel() for p in params.parameters()),
                   weight_bytes=sum(p.numel() * p.element_size()
                                    for p in params.parameters()))
        # (b) retrieval through the cached facade, then generation
        pipe = RagPipeline(cfg, params, db=db, k=K, eps=eps, ef=EF)
        retrieve, decode = pipe.retrieve, M.decode_step
        walls: dict[str, float] = {}
        step_ms: list[float] = []
        step_logits: list = []

        def timed_retrieve(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = retrieve(*a, **kw)
            torch.cuda.synchronize()
            walls["retrieve_s"] = time.perf_counter() - t
            return res

        def timed_decode(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = decode(*a)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            step_logits.append(logits[:, 0])
            return logits, cache

        hits = db.stats()["cache_hits"]
        pipe.retrieve = timed_retrieve
        M.decode_step = timed_decode
        try:
            t0 = time.perf_counter()
            tokens, ids, cert = pipe.generate(
                qs_np[:RAG_Q], prompts % cfg.vocab_size, steps=FAM_STEPS)
            generate_s = time.perf_counter() - t0
        finally:
            M.decode_step = decode
            del pipe.retrieve
        path.bank()
        want_cert = np.array([bool(served4[i].stats.certified)
                              for i in range(RAG_Q)])
        if not (np.array_equal(ids, served_ids)
                and np.array_equal(cert, want_cert)):
            raise AssertionError(f"(b) {name}: retrieved {ids} certified="
                                 f"{cert}, phase 4 served {served_ids} "
                                 f"certified={want_cert}")
        assert_results(torch, sim, graph.vectors, torch.as_tensor(
            ids, device=device), served_scores, eps, f"(b) {name}")
        if tokens.shape != (RAG_Q, FAM_STEPS) or not (
                (tokens >= 0) & (tokens < cfg.vocab_size)).all():
            raise AssertionError(f"(b) {name} tokens {tokens.shape}: out "
                                 "of range")
        read = step_read_bytes(cfg, params, M.init_cache(
            cfg, RAG_Q, RAG_PROMPT + FAM_STEPS + K, device="meta"))
        median_ms = float(np.median(step_ms))
        fam.update(
            cache_hits=db.stats()["cache_hits"] - hits,
            retrieve_s=walls["retrieve_s"],
            qps=RAG_Q / walls["retrieve_s"], generate_s=generate_s,
            decode_steps=len(step_ms), decode_ms_median=median_ms,
            decode_ms_min=min(step_ms), decode_ms_max=max(step_ms),
            decode_tokens_per_s=RAG_Q / (median_ms / 1e3),
            generated_tokens_per_s=RAG_Q * FAM_STEPS / (
                generate_s - walls["retrieve_s"]),
            step_read_bytes=read,
            step_read_bound_ms=read / PEAK_BYTES_PER_S * 1e3)
        log(f"phase 12 {name} (a)-(b): retrieval equal to phase 4's served "
            "results, every row diverse: " + json.dumps(fam))
        # (d) 1. decode against forward along the served sequence
        seq = torch.cat([torch.remainder(torch.as_tensor(
            ids, dtype=torch.int64), cfg.vocab_size), torch.as_tensor(
                prompts % cfg.vocab_size), torch.as_tensor(
                    tokens, dtype=torch.int64)], dim=1).to(device)
        dec = torch.stack(step_logits, dim=1)
        del step_logits
        fam["d_forward"] = decode_against_forward(
            torch, M, cfg, params, seq, dec, seed + 620 + i, device)
        del dec
        log(f"phase 12 {name} (d) decode against forward: "
            + json.dumps(fam["d_forward"]))
        # (c) launches a decode step, the idle share, peak memory
        fam["c_profile"] = decode_profile(torch, M, cfg, params, seq, device)
        fam["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        path.drop()
        log(f"phase 12 {name} (c) decode steps profiled: "
            + json.dumps(fam["c_profile"]))
        del pipe, params, retrieve
        gc.collect()
        torch.cuda.empty_cache()
        # (d) 2. the card against the plain CPU at the least depth
        fam["d_cpu"] = card_against_cpu(torch, M, cfg, seq, seed + 610 + i,
                                        device)
        path.drop()
        log(f"phase 12 {name} (d) card against the plain CPU: "
            + json.dumps(fam["d_cpu"]))
        fam["s"] = time.perf_counter() - t_fam
        out["families"][name] = fam
    report.setdefault("reduced", []).extend([
        f"phase 12 runs llama-3.2-vision-90b at {FAM_VLM_LAYERS} of its 100 "
        "layers (2 of 20 superblocks): 210 GB of bf16 weights do not fit "
        "one 80 GB card",
        f"phase 12 generates {FAM_STEPS} tokens a family, not phase 11's "
        f"{RAG_STEPS}, and the card against the CPU over " + ", ".join(
            f"{k} {v}" for k, v in FAM_CPU_STEPS.items()) + " steps: "
        "phase 12 took 129.4 s at 16 and 2-4 over 200 000 rows (NVIDIA H100 "
        "80GB HBM3, 700 W) against a budget of ~120 s"])
    del db
    gc.collect()
    torch.cuda.empty_cache()
    out["path_s"] = time.perf_counter() - t_path
    out["launches"] = dict(path.total)
    missing = [k for k in PATH12_KERNELS if path.total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the families' path: "
                             f"{missing}")
    report["families_path"] = out
    log("phase 12: " + json.dumps({k: out[k] for k in ("path_s",
                                                        "launches")}))
    return path.total


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

    os.makedirs(OUT, exist_ok=True)
    report: dict = {"argv": sys.argv[1:]}
    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    report["nvidia_smi"] = smi

    device = torch.device("cuda")
    from repro_torch.core import similarity as sim
    from repro_torch.kernels import _build, ops

    walls = report["phase_walls_s"] = {}

    def phase(name, fn, *a):
        """``fn(*a)``, its wall logged on a line of its own and kept."""
        t = time.perf_counter()
        res = fn(*a)
        walls[name] = time.perf_counter() - t
        log(f"phase {name} wall: {walls[name]:.1f} s")
        return res

    t0 = time.perf_counter()
    per_source = _build.build_all()
    build_s = time.perf_counter() - t0
    walls["2"] = build_s
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
    log(f"phase 2 wall: {build_s:.1f} s")

    def kernels_phase():
        x = deep_like(torch, args.n, D, args.seed + 100, device)
        qs = deep_like(torch, LANES, D, args.seed + 101, device)
        timings = check_kernels(torch, ops, sim, x, qs, args.seed, report)
        del x
        torch.cuda.empty_cache()
        return timings

    timings = phase("3", kernels_phase)
    launches, graph, qs_np, eps, served4 = phase(
        "4", main_path, torch, args, report, device)
    qrows, qlaunches = phase("5", compressed_path, torch, report, graph,
                             qs_np[:LANES], args.seed, device)
    timings.update(qrows)
    mrow, slaunches, db6, served6 = phase("6", sharded_path, torch, report,
                                          graph, qs_np, eps, args.seed,
                                          device)
    timings["topk_merge"] = mrow
    flaunches = phase("7", front_door, torch, report, graph, qs_np, eps,
                      served4, args.seed, device)
    rlaunches = phase("11", rag_path, torch, report, graph, qs_np, eps,
                      served4, args.seed, device)
    falaunches = phase("12", families_path, torch, report, graph, qs_np,
                       eps, served4, args.seed, device)
    elaunches = phase("8", elastic_path, torch, report, db6,
                      graph.vectors.cpu().numpy(), qs_np, eps, served6,
                      args.seed, device)
    del db6
    plaunches, hist9 = phase("9", per_query_path, torch, report, graph,
                             qs_np, eps, served4)
    hists = [report["main_path"]["widths"], report["sharded_path"]["widths"]]
    report["path_shape_times"] = phase(
        "after 6", time_at_path_shapes, torch, ops, sim, graph.vectors, hists,
        args.seed + 300, timings)
    report["path9_shape_times"] = phase(
        "after 9", time_phase9_shapes, torch, ops, sim, graph.vectors, hist9,
        args.seed + 400, timings)
    hlaunches = phase("10", hnsw_path, torch, report,
                      graph.vectors[:N10].cpu().numpy(), qs_np, args.seed,
                      device)
    # the gathered scoring's device time per launch as the burst meets it:
    # its launches in phase 4's profiled lockstep batch
    prof = report["main_path"]["profile"]
    row = timings["batch_similarity_gather"]
    row["device_us_fresh_ids"] = row["device_us"]
    row["device_us"] = (prof["sim_gather_device_s"] * 1e6
                        / prof["sim_gather_launches"]
                        if prof["sim_gather_launches"] else None)
    row["device_us_kept"] = prof["sim_gather_launches"]
    # each kernel's launches over the nine paths' runs (each path's own
    # counts are in chip_smoke.json)
    kernels = []
    for name, row in timings.items():
        total = (launches[name] + qlaunches[name] + slaunches[name]
                 + flaunches[name] + rlaunches[name] + falaunches[name]
                 + elaunches[name]
                 + plaunches[name] + hlaunches[name])
        kernels.append(dict(row, launches=int(total)))
    report["kernels"] = kernels
    report["script_s"] = time.perf_counter() - T0
    log(f"script wall: {report['script_s']:.1f} s; phases: "
        + json.dumps({k: round(v, 1) for k, v in walls.items()}))
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
