"""Batched diverse search over a request batch (port of ``repro.core.batch``).

The progressive drivers are per-query host loops (faithful to the paper's
Alg. 2-4 pause/resume structure). These entry points run a whole request
batch as lockstep lanes (``beam_search.init_state`` / ``run_search``):

* ``batch_beam_search``      — Alg. 1 over B queries; done lanes idle.
* ``batch_greedy_diverse``   — beam + adjacency + greedy per query (the
                               paper's greedy baseline at scale): one
                               ``pairwise_adjacency_batch`` and one
                               ``greedy_diversify_batch`` launch for all
                               lanes.
* ``batch_optimal_diverse``  — beam + adjacency + div-A* per query, with a
                               Theorem-2 certificate per lane ("PSS with a
                               fixed K budget"); div-A* runs per lane on the
                               host, as the engine's verify does.
"""
from __future__ import annotations

import torch

from repro_torch.core import beam_search as bs
from repro_torch.core.batch_progressive import _batched_div_astar
from repro_torch.core.graph import FlatGraph
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import extract_round


def batch_beam_search(graph: FlatGraph, qs: torch.Tensor, k: int, L: int,
                      capacity: int | None = None, impl: str | None = None):
    """ids[B, k], scores[B, k] for a query batch qs[B, d], over a float or
    a quantized graph; the lanes run in lockstep, each to its own stop."""
    return bs.beam_search(graph, qs, k, L, capacity, impl)


def _beams(graph: FlatGraph, qs, L: int):
    """Each query's capacity-L queue after Alg. 1 to a stable first L."""
    qs = torch.as_tensor(qs, dtype=torch.float32, device=graph.device)
    state = bs.init_state(graph, qs, L)
    state = bs.run_search(graph, qs, state, stable_limit=L)
    return state.queue.ids, state.queue.scores


def batch_greedy_diverse(graph: FlatGraph, qs, k: int, eps, L: int):
    """Greedy-diversified results (ids[B, k], scores[B, k], count[B]) on the
    graph's device; each lane as ``baselines.greedy_fixed`` at the same L."""
    ids, scores = _beams(graph, qs, L)
    adj = kops.pairwise_adjacency_batch(graph.vectors, ids, eps, graph.metric)
    sel, count = kops.greedy_diversify_batch(scores, adj, k, valid=ids >= 0)
    out_ids, out_sc = extract_round(sel, ids, scores)
    return out_ids, out_sc, count


def batch_optimal_diverse(graph: FlatGraph, qs, k: int, eps, K: int,
                          ef: int = 4, max_expansions: int = 100_000):
    """div-A*-optimal results over a fixed top-K candidate budget.

    Returns (ids[B, k], scores[B, k], total[B], certified[B]) on the graph's
    device. ``certified`` is the per-lane Theorem-2 check: True means the
    result is optimal over the whole database, not just the K candidates
    (under the paper's beam-recall assumption); False lanes should be re-run
    through the progressive driver.
    """
    ids, scores = _beams(graph, qs, K * ef)
    ids, scores = ids[:, :K].contiguous(), scores[:, :K].contiguous()
    adj = kops.pairwise_adjacency_batch(graph.vectors, ids, eps, graph.metric)
    sets, _, complete, min_values = _batched_div_astar(
        torch.where(ids >= 0, scores, float("-inf")), adj, k, max_expansions)
    scores = scores.cpu()
    out_ids, out_sc = extract_round(torch.from_numpy(sets[:, k - 1]),
                                    ids.cpu(), scores)
    certified = (torch.from_numpy(min_values) > scores[:, K - 1]) \
        & torch.from_numpy(complete)
    dev = graph.device
    return (out_ids.to(dev), out_sc.to(dev), out_sc.sum(dim=1).to(dev),
            certified.to(dev))
