"""Flat, fixed-shape proximity graph (port of ``repro.core.graph``).

  vectors    f32[N, d]          the database (float corpora only)
  neighbors  int32[N, M0]       level-0 adjacency, -1 padded
  upper      int32[Lu, N, Mu]   upper-level adjacency; may have Lu == 0
  entry      int                entry node at the top level

The port has no quantized corpora yet: ``make_flat_graph`` and
``from_host`` raise on one rather than storing it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.similarity import query_sim


@dataclasses.dataclass(frozen=True)
class FlatGraph:
    vectors: torch.Tensor
    neighbors: torch.Tensor
    upper: torch.Tensor
    entry: int
    metric: str = "l2"

    @property
    def size(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def num_upper_levels(self) -> int:
        return self.upper.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def _float_corpus(vectors) -> torch.Tensor:
    if not isinstance(vectors, torch.Tensor):
        vectors = np.asarray(vectors)
        if vectors.dtype.kind == "f":
            vectors = torch.from_numpy(np.array(vectors, np.float32))
    if not (isinstance(vectors, torch.Tensor) and vectors.is_floating_point()):
        raise TypeError("repro_torch has no quantized corpora yet; "
                        f"got a corpus of {type(vectors).__name__} "
                        f"{getattr(vectors, 'dtype', '')}")
    return vectors


def make_flat_graph(vectors, neighbors, upper, entry: int, metric: str,
                    device=None) -> FlatGraph:
    """Graph on ``device`` (``cuda`` unless given) from arrays or tensors."""
    device = resolve_device(device)
    vectors = _float_corpus(vectors).to(device, torch.float32).contiguous()

    def int32(a):
        return torch.as_tensor(np.array(a) if not isinstance(a, torch.Tensor)
                               else a).to(device, torch.int32).contiguous()

    if upper is None or upper.shape[0] == 0:
        upper = torch.zeros((0, vectors.shape[0], 1), dtype=torch.int32,
                            device=device)
    return FlatGraph(vectors, int32(neighbors), int32(upper), int(entry),
                     metric)


def from_host(host: dict, device=None) -> FlatGraph:
    """Graph from the dict ``repro.core.graph.to_host`` returns (numpy
    arrays ``vectors``/``neighbors``/``upper``, int ``entry``, str
    ``metric``) — the carrier both packages share one graph through."""
    return make_flat_graph(host["vectors"], host["neighbors"], host["upper"],
                           int(host["entry"]), host["metric"], device=device)


def to_host(graph: FlatGraph) -> dict:
    return dict(vectors=graph.vectors.cpu().numpy(),
                neighbors=graph.neighbors.cpu().numpy(),
                upper=graph.upper.cpu().numpy(),
                entry=int(graph.entry), metric=graph.metric)


def descend(graph: FlatGraph, q: torch.Tensor) -> int:
    """Greedy top-down descent through the upper HNSW levels.

    Returns the level-0 entry node for query ``q``. Each level runs a greedy
    walk: move to the best-scoring neighbor while it improves.
    """
    cur = int(graph.entry)
    cur_sim = query_sim(q, graph.vectors[cur][None, :], graph.metric)[0]
    for lvl in range(graph.num_upper_levels):   # upper[0] is the TOP level
        level_nbrs = graph.upper[lvl]
        for _ in range(graph.size):
            nbrs = level_nbrs[cur]
            sims = query_sim(q, graph.vectors[nbrs.clamp(min=0)], graph.metric)
            sims = torch.where(nbrs >= 0, sims, float("-inf"))
            j = int(torch.argmax(sims))
            if not bool(sims[j] > cur_sim):
                break
            cur, cur_sim = int(nbrs[j]), sims[j]
    return cur
