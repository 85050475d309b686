"""Baselines the paper compares against (§II-B, §IV-A), port of
``repro.core.baselines``.

* ``greedy_fixed``  — beam search with fixed L (default 400, as the paper's
  Greedy_400), then one greedy diversification pass (one adjacency and one
  greedy launch at B = 1). May return < k results; the paper scores missing
  slots as 0, and so do we.
* ``div_astar_oracle`` — exact top-X candidates (brute force on the
  device) + div-A*: the ground-truth generator for recall (the paper's
  div-A* baseline).
* ``ip_greedy``     — Hirata et al. [24] (Eqs. 1-2): greedy selection on
  f(p, S) = lambda * <p,q> + c * (1 - lambda) * min pairwise dist(S ∪ {p});
  applies to ip/cos spaces, included for the Fig. 8 reproduction. The
  reference's numpy loop, over the beam's rows brought to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import div_astar as da
from repro_torch.core.beam_search import beam_search
from repro_torch.core.diversity_graph import build_adjacency
from repro_torch.core.graph import FlatGraph
from repro_torch.core.pgs import DiverseResult, selection
from repro_torch.core.progressive import SearchStats
from repro_torch.core.theorems import theorem2_min_value
from repro_torch.index.flat import exact_topk
from repro_torch.kernels import ops as kops


def greedy_fixed(graph: FlatGraph, q, k: int, eps: float,
                 L: int = 400) -> DiverseResult:
    ids, scores = beam_search(graph, torch.as_tensor(
        q, dtype=torch.float32, device=graph.device), L, L)
    adj = build_adjacency(graph, ids, eps)
    sel, _ = kops.greedy_diversify(scores, adj, k, valid=ids >= 0)
    out_ids, out_sc = selection(sel, ids, scores)   # missing = 0
    return DiverseResult(out_ids, out_sc, float(out_sc.sum()),
                         SearchStats(K_final=L))


def div_astar_oracle(vectors, metric: str, q, k: int, eps: float,
                     X: int = 2048, max_expansions: int = 2_000_000,
                     grow_until_certified: bool = True,
                     device=None) -> DiverseResult:
    """Exact candidates + div-A*; X doubles until Theorem 2 certifies global
    optimality (so the ground truth is optimal over the WHOLE dataset).

    ``vectors`` is an array or a tensor; a tensor is scored where it lies,
    an array on ``device`` (``cuda`` unless given). The candidates' G^eps is
    one single-lane adjacency launch; div-A* runs on the host.
    """
    dev = (vectors.device if isinstance(vectors, torch.Tensor)
           else resolve_device(device))
    vectors = torch.as_tensor(vectors, dtype=torch.float32, device=dev)
    n = vectors.shape[0]
    X = min(X, n)
    while True:
        ids, scores = exact_topk(q, vectors, X, metric, device=dev)
        ids, scores = ids[0], scores[0]
        vecs = vectors[torch.as_tensor(ids, device=dev).long()]
        adj = kops.pairwise_adjacency(vecs, eps, metric)
        res = da.div_astar(scores, adj.cpu().numpy(), k,
                           max_expansions=max_expansions)
        ok = np.isfinite(res.best_scores[k - 1])
        min_value = float(theorem2_min_value(
            torch.from_numpy(res.best_scores), k))
        certified = ok and (min_value > float(scores[X - 1]) or X >= n)
        if certified or not grow_until_certified or X >= n:
            break
        X = min(2 * X, n)
    out_ids, out_sc = selection(res.best_sets[k - 1], ids, scores)
    st = SearchStats(K_final=X, certified=bool(res.complete))
    return DiverseResult(out_ids, out_sc, float(out_sc.sum()), st)


def ip_greedy(graph: FlatGraph, q, k: int, lam: float, c: float = 1.0,
              L: int = 400) -> DiverseResult:
    """IP-greedy (Eq. 2). dist = euclidean distance (as in [24])."""
    ids, scores = beam_search(graph, torch.as_tensor(
        q, dtype=torch.float32, device=graph.device), L, L)
    ids_np = ids.cpu().numpy()
    valid = ids_np >= 0
    vecs = graph.vectors[ids.clamp(min=0).long()].cpu().numpy()
    rel = scores.cpu().numpy()  # <p, q> (ip) or cos
    # pairwise euclidean distances among candidates
    d2 = np.maximum(
        (vecs ** 2).sum(1)[:, None] + (vecs ** 2).sum(1)[None, :]
        - 2.0 * vecs @ vecs.T, 0.0)
    dist = np.sqrt(d2)
    chosen: list[int] = []
    cur_min = np.inf
    for _ in range(k):
        best_j, best_f = -1, -np.inf
        for j in range(len(ids_np)):
            if not valid[j] or j in chosen:
                continue
            new_min = cur_min if not chosen else min(
                cur_min, float(dist[j, chosen].min()))
            if not chosen:
                new_min_term = 0.0
            else:
                new_min_term = new_min
            f = lam * float(rel[j]) + c * (1.0 - lam) * new_min_term
            if f > best_f:
                best_f, best_j = f, j
        if best_j < 0:
            break
        if chosen:
            cur_min = min(cur_min, float(dist[best_j, chosen].min()))
        chosen.append(best_j)
    out_ids = np.full(k, -1, np.int32)
    out_sc = np.zeros(k, np.float32)
    for t, j in enumerate(chosen):
        out_ids[t] = ids_np[j]
        out_sc[t] = rel[j]
    st = SearchStats(K_final=L)
    return DiverseResult(out_ids, out_sc, float(out_sc.sum()), st)
