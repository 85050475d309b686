"""The paper's Theorems 1 and 2 as executable predicates (PyTorch port).

Port of ``theorem1_K``, ``theorem2_min_value`` and ``theorem2_holds`` from
``repro.core.theorems``; the audit/recheck helpers and Theorem 3 come with
the slice that ports the result cache.

Theorem 1 (degree bound, PDS): if K >= sum_{v in Phi}(phi_v + 1) + 1 where
Phi holds the k-1 highest-degree nodes of G^eps over the top-K candidates,
the top-K candidates suffice to contain the optimal diverse set.

Theorem 2 (score bound, PSS): with optimal sizes-1..k scores S_1..S_k over
the top-K candidates and s_K the K-th candidate score, if
min_{0<i<k} (S_k - S_i)/(k - i) > s_K the current R_k is globally optimal.
"""
from __future__ import annotations

import torch


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
