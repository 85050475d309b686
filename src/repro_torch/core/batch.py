"""Batched beam search over a request batch (port of ``repro.core.batch``:
``batch_beam_search``).

``batch_greedy_diverse`` and ``batch_optimal_diverse`` come with a later
slice.
"""
from __future__ import annotations

import torch

from repro_torch.core import beam_search as bs
from repro_torch.core.graph import FlatGraph


def batch_beam_search(graph: FlatGraph, qs: torch.Tensor, k: int, L: int,
                      capacity: int | None = None, impl: str | None = None):
    """ids[B, k], scores[B, k] for a query batch qs[B, d], over a float or
    a quantized graph; the lanes run in lockstep, each to its own stop."""
    return bs.beam_search(graph, qs, k, L, capacity, impl)
