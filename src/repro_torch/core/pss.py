"""Progressive Score Search — paper Algorithm 4 (Theorem 2 early stop),
port of ``repro.core.pss``.

Phase 1 runs PGS (guarantees a size-k diverse set exists among the
candidates and warm-starts the queue). Each round then:
  1. builds G^eps over the first K candidates (incremental extension),
  2. runs div-A* for the optimal sets of sizes 1..k (on the host,
     ``core.div_astar``, its inputs copied off the device once),
  3. computes minValue = min_i (S_k - S_i)/(k - i)  (Theorem 2),
  4. stops if minValue > s_K — the result is then certified optimal over the
     whole database (under the paper's 100%-recall beam assumption);
     otherwise resumes ProgressiveBeamSearch* until the frontier score drops
     below minValue and sets K <- stable_count // ef.

Per query it returns what the batched engine's lane returns for the same
query (``core.batch_progressive.batch_pss``), bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import div_astar as da
from repro_torch.core.diversity_graph import prefix_adjacency
from repro_torch.core.graph import FlatGraph
from repro_torch.core.pgs import DiverseResult, pgs, selection
from repro_torch.core.theorems import theorem2_min_value


def pss(graph: FlatGraph, q, k: int, eps: float, ef: int = 40,
        max_iters: int = 64, max_expansions: int = 400_000) -> DiverseResult:
    pgs_res, driver, K = pgs(graph, q, k, eps, ef)
    n = graph.size
    adj = None
    prev_ids = None
    best = pgs_res  # fallback if certification never fires
    for _ in range(max_iters):
        K = max(k, min(K, n))
        ids, scores = driver.prefix(K)
        adj = prefix_adjacency(graph, adj, prev_ids, ids, K, eps)
        prev_ids = ids
        res, ids_np, sc_np = da.prefix_div_astar(ids, scores, adj, k,
                                                 max_expansions)
        driver.stats.div_calls += 1
        if np.isfinite(res.best_scores[k - 1]):
            out_ids, out_sc = selection(res.best_sets[k - 1], ids_np, sc_np)
            best = DiverseResult(out_ids, out_sc, float(out_sc.sum()),
                                 driver.stats)
        min_value = float(theorem2_min_value(
            torch.from_numpy(res.best_scores), k))
        s_K = float(sc_np[K - 1]) if K <= ids_np.shape[0] else -np.inf
        if min_value > s_K:
            driver.stats.certified = bool(res.complete)
            break
        if driver.stats.exhausted or K >= n:
            break
        stable_before = driver.stable_prefix_len()
        stable = driver.expand_until_below(min_value)
        if stable <= stable_before:  # no progress — graph exhausted
            driver.stats.exhausted = True
            if stable >= n or driver.capacity >= driver.max_capacity:
                K = min(stable, n)
                continue
        K = max(k, stable // ef)
    driver.stats.K_final = K
    return best._replace(stats=driver.stats)
