"""Public API: one entry point for approximate diverse k-NN search (port of
``repro.core.api``).

    result = diverse_search(graph, q, k=10, eps=0.8, method="pss", ef=40)

``method``: "pss" (default, paper's best), "pds", "pgs", "greedy"
(fixed-beam baseline), "ip_greedy". The query carries its own (k, eps) as in
the paper's Definition 1 — no index rebuild for new diversification levels.
The search runs on the graph's device.
"""
from __future__ import annotations

from typing import Literal

from repro_torch.core.baselines import greedy_fixed, ip_greedy
from repro_torch.core.graph import FlatGraph
from repro_torch.core.pds import pds
from repro_torch.core.pgs import DiverseResult, pgs
from repro_torch.core.pss import pss

Method = Literal["pss", "pds", "pgs", "greedy", "ip_greedy"]


def diverse_search(graph: FlatGraph, q, k: int, eps: float,
                   method: Method = "pss", ef: int = 40,
                   **kwargs) -> DiverseResult:
    if method == "pss":
        return pss(graph, q, k, eps, ef, **kwargs)
    if method == "pds":
        return pds(graph, q, k, eps, ef, **kwargs)
    if method == "pgs":
        res, _, _ = pgs(graph, q, k, eps, ef, **kwargs)
        return res
    if method == "greedy":
        return greedy_fixed(graph, q, k, eps, **kwargs)
    if method == "ip_greedy":
        lam = kwargs.pop("lam", 0.7)
        return ip_greedy(graph, q, k, lam, **kwargs)
    raise ValueError(f"unknown method {method!r}")
