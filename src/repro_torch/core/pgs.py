"""Progressive Greedy Search — paper Algorithm 2 (port of ``repro.core.pgs``).

Greedy diversification inside the progressive framework: stabilize K*ef
candidates, greedily select among the first K, and grow K by k until the
diverse set reaches size k. Greedy over a sorted prefix is prefix-monotone
(selection decisions depend only on earlier selections), so re-running
greedy over the longer prefix reproduces Alg. 2's incremental R exactly.

Each round is one single-lane adjacency launch (``build_adjacency``) and one
single-lane greedy launch (``kernels.ops.greedy_diversify``) over the
driver's padded prefix; the batched engine runs the same round as one
``fused_round`` launch per lane group.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.diversity_graph import build_adjacency
from repro_torch.core.graph import FlatGraph
from repro_torch.core.progressive import ProgressiveDriver, SearchStats
from repro_torch.kernels import ops as kops


class DiverseResult(NamedTuple):
    ids: np.ndarray      # int32[k], -1 padded
    scores: np.ndarray   # f32[k]
    total: float
    stats: SearchStats


def selection(sel, ids, scores) -> tuple[np.ndarray, np.ndarray]:
    """Global ids (-1) and scores (0.0) of the local picks ``sel`` into a
    candidate list (ids, scores); every argument on the host or the card."""
    sel, ids, scores = (a.cpu().numpy() if isinstance(a, torch.Tensor)
                        else np.asarray(a) for a in (sel, ids, scores))
    out_ids = np.where(sel >= 0, ids[np.maximum(sel, 0)], -1)
    out_sc = np.where(sel >= 0, scores[np.maximum(sel, 0)], 0.0)
    return out_ids.astype(np.int32), out_sc.astype(np.float32)


def _greedy_prefix(graph: FlatGraph, driver: ProgressiveDriver, K: int,
                   eps: float, k: int):
    ids, scores = driver.prefix(K)
    adj = build_adjacency(graph, ids, eps)
    sel, count = kops.greedy_diversify(scores, adj, k, valid=ids >= 0)
    driver.stats.div_calls += 1
    return ids, scores, sel, int(count)


def pgs(graph: FlatGraph, q, k: int, eps: float, ef: int = 40,
        driver: ProgressiveDriver | None = None,
        max_iters: int = 64) -> tuple[DiverseResult, ProgressiveDriver, int]:
    """Returns (result, driver, K_final) — PSS reuses the driver and K."""
    if driver is None:
        driver = ProgressiveDriver(graph, q, ef, k)
    K = k
    sel = None
    ids = scores = None
    for _ in range(max_iters):
        stable = driver.ensure_stable(K * ef)
        exhausted = stable < min(K * ef, graph.size)
        if exhausted:
            # graph fully explored: run greedy over everything we have
            K = max(K, stable)
        ids, scores, sel, count = _greedy_prefix(graph, driver, K, eps, k)
        if count >= k:
            break
        if exhausted:
            driver.stats.exhausted = True   # cannot produce k diverse results
            break
        K += k
    out_ids, out_sc = selection(sel, ids, scores)
    driver.stats.K_final = K
    res = DiverseResult(out_ids, out_sc, float(out_sc.sum()), driver.stats)
    return res, driver, K
