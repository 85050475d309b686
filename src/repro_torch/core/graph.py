"""Flat, fixed-shape proximity graph (port of ``repro.core.graph``).

  vectors    f32[N, d]          the database, or a quantized corpus
                                (``quant.Int8Corpus`` / ``quant.PQCorpus``)
  neighbors  int32[N, M0]       level-0 adjacency, -1 padded
  upper      int32[Lu, N, Mu]   upper-level adjacency; may have Lu == 0
  entry      int                entry node at the top level

Quantized graphs are level-0 only (the upper-level descent reads float
rows), as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import quant, resolve_device


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


def _corpus(vectors, device: torch.device):
    """The graph's corpus on ``device``: a quantized corpus as it is, else
    float32 rows."""
    if quant.is_quantized(vectors):
        return vectors.to(device)
    if isinstance(vectors, dict):             # a quantized corpus, on the host
        return quant.corpus_from_host(vectors, device)
    if not isinstance(vectors, torch.Tensor):
        vectors = np.asarray(vectors)
        if vectors.dtype.kind == "f":
            vectors = torch.from_numpy(np.array(vectors, np.float32))
    if not (isinstance(vectors, torch.Tensor) and vectors.is_floating_point()):
        raise TypeError("a graph's corpus is float rows or a quantized "
                        "corpus (quant.Int8Corpus / quant.PQCorpus); got "
                        f"{type(vectors).__name__} "
                        f"{getattr(vectors, 'dtype', '')}")
    return vectors.to(device, torch.float32).contiguous()


def make_flat_graph(vectors, neighbors, upper, entry: int, metric: str,
                    device=None) -> FlatGraph:
    """Graph on ``device`` (``cuda`` unless given) from arrays or tensors.

    ``vectors`` may be a float corpus or a quantized one; a quantized graph
    takes no upper levels."""
    device = resolve_device(device)
    if quant.is_quantized(vectors) or isinstance(vectors, dict):
        if upper is not None and upper.shape[0] != 0:
            raise ValueError(
                "quantized corpora do not support upper HNSW levels; "
                "build a level-0 (knng) graph instead")
    vectors = _corpus(vectors, device)

    def int32(a):
        return torch.as_tensor(np.array(a) if not isinstance(a, torch.Tensor)
                               else a).to(device, torch.int32).contiguous()

    if upper is None or upper.shape[0] == 0:
        upper = torch.zeros((0, vectors.shape[0], 1), dtype=torch.int32,
                            device=device)
    return FlatGraph(vectors, int32(neighbors), int32(upper), int(entry),
                     metric)


def to_device(graph: FlatGraph, device) -> FlatGraph:
    """The graph on ``device``: itself when it lies there already."""
    device = torch.device(device)
    if graph.device.type == device.type and device.index in (
            None, graph.device.index):
        return graph
    return dataclasses.replace(
        graph, vectors=graph.vectors.to(device),
        neighbors=graph.neighbors.to(device), upper=graph.upper.to(device))


def from_host(host: dict, device=None) -> FlatGraph:
    """Graph from the dict ``repro.core.graph.to_host`` returns (numpy
    arrays ``vectors``/``neighbors``/``upper``, int ``entry``, str
    ``metric``) — the carrier both packages share one graph through. A
    quantized corpus's ``vectors`` is the dict ``quant.corpus_to_host``
    gives."""
    return make_flat_graph(host["vectors"], host["neighbors"], host["upper"],
                           int(host["entry"]), host["metric"], device=device)


def to_host(graph: FlatGraph) -> dict:
    vectors = (quant.corpus_to_host(graph.vectors)
               if quant.is_quantized(graph.vectors)
               else graph.vectors.cpu().numpy())
    return dict(vectors=vectors, neighbors=graph.neighbors.cpu().numpy(),
                upper=graph.upper.cpu().numpy(),
                entry=int(graph.entry), metric=graph.metric)

