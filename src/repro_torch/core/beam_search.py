"""Beam-search state (port of the parts of ``repro.core.beam_search`` the
batched engine needs: ``SearchState`` and ``init_state``).

The per-query loops (``run_search``, ``resume_search``, ``beam_search``,
``rebuild_for_growth``) come with the per-query drivers' slice; the batched
engine runs its own lockstep burst and rebuild
(``core.batch_progressive``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import queue as qmod
from repro_torch.core.graph import FlatGraph, descend
from repro_torch.core.queue import Queue
from repro_torch.kernels import ops as kops


class SearchState(NamedTuple):
    queue: Queue
    visited: torch.Tensor  # bool[..., N] — nodes already EXPANDED
    steps: torch.Tensor    # int32[...]


def init_state(graph: FlatGraph, qs: torch.Tensor, capacity: int,
               impl: str | None = None) -> SearchState:
    """Start state of each query in qs[B, d] (leading lane axis): the queue
    seeded with the entry point (after HNSW descent when the graph has upper
    levels), nothing visited, zero steps."""
    B = qs.shape[0]
    dev = graph.device
    if graph.num_upper_levels:
        entries = [descend(graph, q) for q in qs]
    else:
        entries = [int(graph.entry)] * B
    entry = torch.tensor(entries, dtype=torch.int32, device=dev)
    s0 = kops.batch_similarity_gather(qs, graph.vectors, entry[:, None],
                                      graph.metric, impl)[:, 0]
    queue = qmod.make_queue(capacity, (B,), dev)
    queue.ids[:, 0] = entry
    queue.scores[:, 0] = s0
    queue.stable[:, 0] = False
    visited = torch.zeros((B, graph.size), dtype=torch.bool, device=dev)
    return SearchState(queue, visited,
                       torch.zeros(B, dtype=torch.int32, device=dev))
