"""Diversity-graph helpers (port of ``repro.core.diversity_graph``).

This slice ports ``degrees`` only; the engine builds G^eps through
``kernels.ops.pairwise_adjacency_batch``. ``build_adjacency`` and
``extend_adjacency`` come with the per-query drivers' slice.
"""
from __future__ import annotations

import torch


def degrees(adj: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Node degrees of G^eps (last axis; leading axes are lanes)."""
    d = torch.sum(adj, dim=-1).to(torch.int32)
    if valid is not None:
        d = torch.where(valid, d, 0)
    return d
