"""The paper's Theorems 1-3 as executable predicates (port of
``repro.core.theorems``).

Theorem 1 (degree bound, PDS): if K >= sum_{v in Phi}(phi_v + 1) + 1 where
Phi holds the k-1 highest-degree nodes of G^eps over the top-K candidates,
the top-K candidates suffice to contain the optimal diverse set.

Theorem 2 (score bound, PSS): with optimal sizes-1..k scores S_1..S_k over
the top-K candidates and s_K the K-th candidate score, if
min_{0<i<k} (S_k - S_i)/(k - i) > s_K the current R_k is globally optimal.

Theorem 3 (recall bound): Recall_P >= (1 - K*lambda/(K-k+1))^k.

The audit (``theorem2_audit`` / ``theorem2_recheck``) runs on a recorded
candidate frontier: the frontier's rows are gathered where the corpus lies
(a host corpus on the host, so only those rows move to the device), G^eps
is one batched adjacency launch at B = 1 (``kernels.ops.pairwise_adjacency``)
and div-A* runs on the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device


def theorem1_K(degrees: torch.Tensor, k: int,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Sufficient candidate count K from node degrees of G^eps (last axis;
    leading axes are lanes)."""
    deg = degrees.to(torch.int32)
    if valid is not None:
        deg = torch.where(valid, deg, -1)
    if k <= 1:
        return torch.ones(deg.shape[:-1], dtype=torch.int32, device=deg.device)
    top = torch.sort(deg, dim=-1, descending=True).values[..., : k - 1]
    top = torch.clamp(top, min=0)  # fewer than k-1 valid nodes: treat as deg 0
    return (torch.sum(top + 1, dim=-1) + 1).to(torch.int32)


def theorem2_min_value(best_scores: torch.Tensor, k: int) -> torch.Tensor:
    """minValue = min_{0<i<k} (S_k - S_i)/(k-i); +inf when k == 1.

    best_scores[..., i] = optimal total score of size i+1 (-inf when that
    size is infeasible within the candidates — those i are skipped). All
    arithmetic in float32, as the reference.
    """
    best_scores = best_scores.to(torch.float32)
    if k <= 1:
        return torch.full(best_scores.shape[:-1], float("inf"),
                          dtype=torch.float32, device=best_scores.device)
    s_k = best_scores[..., k - 1: k]
    s_i = best_scores[..., : k - 1]
    i = torch.arange(1, k, dtype=torch.int32, device=best_scores.device)
    gaps = (s_k - s_i) / (k - i)
    gaps = torch.where(torch.isfinite(s_i), gaps, float("inf"))
    return torch.min(gaps, dim=-1).values


def theorem2_holds(best_scores: torch.Tensor, k: int, s_K) -> torch.Tensor:
    return theorem2_min_value(best_scores, k) > s_K


def theorem3_recall_bound(K: float, k: int, lam: float) -> float:
    """Lower bound on the diverse-search recall given Ak-NNS recall 1-lam."""
    if K - k + 1 <= 0:
        return 0.0
    base = 1.0 - (K * lam) / (K - k + 1)
    return max(0.0, base) ** k


def frontier_rows(vectors, ids, device=None) -> torch.Tensor:
    """Rows ``vectors[ids]`` as float32 on the device: a tensor corpus is
    gathered where it lies; a host corpus (numpy) is gathered on the host
    and only those rows move, to ``device`` (``cuda`` unless given)."""
    ids = np.asarray(ids, np.int64)
    if isinstance(vectors, torch.Tensor):
        rows = vectors[torch.as_tensor(ids, device=vectors.device)]
        return rows.to(torch.float32)
    rows = np.ascontiguousarray(np.asarray(vectors)[ids], np.float32)
    return torch.from_numpy(rows).to(resolve_device(device))


def theorem2_audit(vectors, metric: str, cand_ids, cand_scores, eps,
                   k: int, max_expansions: int = 100_000, *, device=None,
                   impl: str | None = None):
    """Theorem-2 certificate audit returning the certificate's numbers.

    Re-runs div-A* from scratch on the recorded ``(cand_ids, cand_scores)``
    (global ids into ``vectors``, a host array or a tensor; -1 rows are
    padding) and re-evaluates ``minValue > s_K``. Returns ``(certified,
    selected_global_ids, min_value, s_K)``; ``min_value - s_K`` is the
    certificate's slack, which the result cache turns into a query-drift
    threshold (:func:`theorem2_slack_threshold`). An empty or all-padding
    frontier is never certified. ``device`` is where a host corpus's rows
    go; ``impl`` picks the adjacency's rung.
    """
    from repro_torch.core import div_astar as da
    from repro_torch.kernels import ops as kops

    cand_ids = np.asarray(cand_ids)
    cand_scores = np.asarray(cand_scores)
    K = len(cand_ids)
    if K == 0 or not (cand_ids >= 0).any():
        return False, np.full(k, -1, np.int32), -np.inf, np.inf
    valid = cand_ids >= 0
    vecs = frontier_rows(vectors, np.maximum(cand_ids, 0), device)
    adj = kops.pairwise_adjacency(
        vecs, eps, metric, torch.as_tensor(valid, device=vecs.device),
        impl=impl)
    res = da.div_astar(np.where(valid, cand_scores, -np.inf), adj.cpu().numpy(),
                       k, max_expansions=max_expansions)
    min_value = float(theorem2_min_value(torch.from_numpy(res.best_scores), k))
    s_K = float(cand_scores[K - 1])
    certified = bool((min_value > s_K) and res.complete)
    sel = res.best_sets[k - 1]
    sel_ids = np.where(sel >= 0, cand_ids[np.maximum(sel, 0)], -1)
    return certified, sel_ids.astype(np.int32), min_value, s_K


def theorem2_recheck(vectors, metric: str, cand_ids, cand_scores, eps,
                     k: int, max_expansions: int = 100_000, *, device=None,
                     impl: str | None = None):
    """Independent Theorem-2 certificate audit over a candidate frontier:
    engine-free, so it can audit a served result's certificate without
    trusting the engine that produced it. Returns ``(certified,
    selected_global_ids)``; a sound certificate means ``certified`` is True
    and the selected ids equal the served ones."""
    certified, sel_ids, _, _ = theorem2_audit(
        vectors, metric, cand_ids, cand_scores, eps, k,
        max_expansions=max_expansions, device=device, impl=impl)
    return certified, sel_ids


def theorem2_slack_threshold(slack: float, k: int,
                             lipschitz: float = 1.0) -> float:
    """Max per-query drift under which a Theorem-2 certificate survives.

    Rescoring the same frontier against a query ``q'`` at probe-space
    distance ``delta`` from ``q`` moves every candidate score by at most
    ``Delta = lipschitz * delta`` (``l2``: 1; ``cos``: 1 on the unit sphere;
    ``ip``: the largest corpus norm). G^eps does not depend on the query, so
    each best size-``i`` total moves by at most ``i * Delta``; the worst gap
    term drops by at most ``(2k-1) * Delta`` while ``s_K`` rises by at most
    ``Delta``, so the certificate holds while ``2k * Delta < slack``, i.e.
    ``delta < slack / (2k * lipschitz)``. The threshold is a probe filter:
    the cache still rechecks every hit. Infinite slack (``k == 1``) gives an
    infinite threshold; non-positive slack gives 0.0.
    """
    if not slack > 0.0:
        return 0.0
    if not math.isfinite(slack):
        return math.inf
    return slack / (2.0 * max(int(k), 1) * float(lipschitz))
