"""Progressive Degree Search — paper Algorithm 3 (Theorem 1 stopping rule),
port of ``repro.core.pds``.

Stabilize K*ef candidates, build G^eps over the first K, recompute
K <- sum over the k-1 highest degrees (phi_v + 1) + 1, and loop until the
first K*ef candidates are already stable. Then one div-A* call returns the
certified-optimal diverse set over the candidates.

The paper reports (its §IV-B, Table IV) that this estimate explodes at high
diversification — the driver honours that with ``max_K`` and flags the query
N/A (``stats.exhausted``, exactly how the paper reports those cells).
"""
from __future__ import annotations

from repro_torch.core import div_astar as da
from repro_torch.core.diversity_graph import degrees, prefix_adjacency
from repro_torch.core.graph import FlatGraph
from repro_torch.core.pgs import DiverseResult, selection
from repro_torch.core.progressive import ProgressiveDriver
from repro_torch.core.theorems import theorem1_K


def pds(graph: FlatGraph, q, k: int, eps: float, ef: int = 40,
        max_K: int | None = None, max_iters: int = 64,
        max_expansions: int = 400_000) -> DiverseResult:
    driver = ProgressiveDriver(graph, q, ef, k)
    n = graph.size
    max_K = max_K or n
    K = k
    adj = None
    prev_ids = None
    for _ in range(max_iters):
        stable = driver.ensure_stable(K * ef)
        ids, scores = driver.prefix(K)
        adj = prefix_adjacency(graph, adj, prev_ids, ids, K, eps)
        prev_ids = ids
        K_new = int(theorem1_K(degrees(adj, ids >= 0), k))
        K_new = min(K_new, n)
        if K_new > max_K:
            driver.stats.exhausted = True
            break
        if stable >= min(K_new * ef, n):
            K = K_new
            break
        K = K_new
        if stable < min(K * ef, n) and stable == driver.stable_prefix_len() \
                and stable >= n:
            break

    ids, scores = driver.prefix(K)
    adj = prefix_adjacency(graph, adj, prev_ids, ids, K, eps)
    res, ids_np, sc_np = da.prefix_div_astar(ids, scores, adj, k,
                                             max_expansions)
    driver.stats.div_calls += 1
    driver.stats.certified = bool(res.complete) and not driver.stats.exhausted
    driver.stats.K_final = K
    out_ids, out_sc = selection(res.best_sets[k - 1], ids_np, sc_np)
    return DiverseResult(out_ids, out_sc, float(out_sc.sum()), driver.stats)
