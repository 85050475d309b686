"""Diversity-graph construction over a candidate prefix (paper Def. 2), port
of ``repro.core.diversity_graph``.

``build_adjacency`` is the single-lane ``kernels.ops.pairwise_adjacency``
(one launch of the batched adjacency kernel at B = 1) over the candidates'
rows. ``extend_adjacency`` is the incremental extension the paper uses in
PDS/PSS: when the candidate prefix grows from K_old to K_new, only the new
rows/cols are scored, with ``kernels.ops.batch_similarity_many`` (the
``sim_many`` kernel), as the reference scores them. The batched engine
builds its G^eps through ``kernels.ops.pairwise_adjacency_batch``.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import FlatGraph
from repro_torch.kernels import ops as kops


def build_adjacency(graph: FlatGraph, ids: torch.Tensor, eps,
                    impl: str | None = None) -> torch.Tensor:
    """Adjacency bool[K, K] among candidate ids (-1 = padding, masked out)."""
    vecs = graph.vectors[ids.clamp(min=0).long()]
    return kops.pairwise_adjacency(vecs, eps, graph.metric, ids >= 0,
                                   impl=impl)


def extend_adjacency(graph: FlatGraph, old_adj: torch.Tensor,
                     old_ids: torch.Tensor, new_ids: torch.Tensor, eps,
                     impl: str | None = None) -> torch.Tensor:
    """Extend a K_old adjacency with newly discovered candidates.

    ``new_ids`` is the FULL new prefix (length K_new >= K_old) whose first
    K_old entries must equal ``old_ids``. Only the (K_new - K_old) new
    rows/cols are computed fresh; the fresh block's diagonal and every
    invalid row or column carry no edge.
    """
    k_old = old_ids.shape[0]
    k_new = new_ids.shape[0]
    if k_new == k_old:
        return old_adj
    dev = new_ids.device
    fresh = new_ids[k_old:]
    fresh_vecs = graph.vectors[fresh.clamp(min=0).long()]
    all_vecs = graph.vectors[new_ids.clamp(min=0).long()]
    valid_new = new_ids >= 0
    # sims of fresh rows vs ALL candidates (old + fresh)
    sims = kops.batch_similarity_many(fresh_vecs, all_vecs, graph.metric,
                                      impl=impl)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
    rows = (sims > eps) & valid_new[None, :] & (fresh >= 0)[:, None]
    # kill diagonal within the fresh block
    diag = (torch.arange(k_new - k_old, device=dev)[:, None] + k_old
            == torch.arange(k_new, device=dev)[None, :])
    rows = rows & ~diag
    adj = torch.zeros((k_new, k_new), dtype=torch.bool, device=dev)
    adj[:k_old, :k_old] = old_adj
    adj[k_old:, :] = rows
    adj[:, k_old:] = rows.T
    return adj


def prefix_adjacency(graph: FlatGraph, adj, prev_ids, ids: torch.Tensor,
                     K: int, eps) -> torch.Tensor:
    """G^eps over the prefix ``ids`` for PDS/PSS: ``extend_adjacency`` of the
    previous prefix's ``adj`` when K covers the previous padded bucket and
    ``ids`` starts with it (compared over the whole bucket, -1 padding
    included, as the reference compares), else ``build_adjacency``."""
    if (adj is not None and prev_ids is not None
            and K >= prev_ids.shape[0]
            and torch.equal(ids[: prev_ids.shape[0]], prev_ids)):
        return extend_adjacency(graph, adj, prev_ids, ids, eps)
    return build_adjacency(graph, ids, eps)


def degrees(adj: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Node degrees of G^eps (last axis; leading axes are lanes)."""
    d = torch.sum(adj, dim=-1).to(torch.int32)
    if valid is not None:
        d = torch.where(valid, d, 0)
    return d
