"""Beam search (paper Alg. 1) and progressive beam search (paper §III) over
a lane axis (port of ``repro.core.beam_search``: ``SearchState``,
``init_state``, ``run_search``, ``resume_search``, ``beam_search``,
``progressive_beam_search``, ``rebuild_for_growth``).

The reference vmaps one ``lax.while_loop`` per query; here the lanes run
in lockstep: each iteration expands the first unstable entry of every lane
still running and leaves a stopped lane's state as it was, so each lane
ends where its own loop would. Float corpora score the expanded node's
neighbour rows with ``kops.batch_similarity_gather``; quantized corpora
score the gathered compressed rows with ``quant.score_rows`` against a
query view prepared once per search.

Lanes may search different graphs stacked in one corpus (the shards of
``sharded_search``): ``row_offset`` gives each lane the first row of its
graph, and its queue, visited set and neighbour lists hold ids local to it.

``progressive_beam_search`` and ``rebuild_for_growth`` serve the per-query
drivers (``core.progressive.ProgressiveDriver``, one lane); the batched
engine runs its own burst and rebuild (``core.batch_progressive``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import quant
from repro_torch.core import queue as qmod
from repro_torch.core.bucketing import next_pow2
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
    if quant.is_quantized(graph.vectors):
        qprep = quant.prepare_query(graph.vectors, qs, graph.metric)
        s0 = quant.score_rows(qprep, graph.vectors, entry[:, None],
                              graph.metric)[:, 0]
    else:
        s0 = kops.batch_similarity_gather(qs, graph.vectors, entry[:, None],
                                          graph.metric, impl)[:, 0]
    queue = qmod.make_queue(capacity, (B,), dev)
    queue.ids[:, 0] = entry
    queue.scores[:, 0] = s0
    queue.stable[:, 0] = False
    visited = torch.zeros((B, graph.size), dtype=torch.bool, device=dev)
    return SearchState(queue, visited,
                       torch.zeros(B, dtype=torch.int32, device=dev))


def _occupied_width(n: int, capacity: int) -> int:
    return min(capacity, next_pow2(max(n, 1)))


def _search_loop(vectors, neighbors, qs, state: SearchState, stable_limit,
                 min_value, max_steps, metric: str, impl: str | None = None,
                 row_offset=None) -> SearchState:
    """The shared loop: while a lane's first unstable entry among its first
    ``stable_limit`` exists, scores at least ``min_value`` and the lane has
    taken fewer than ``max_steps`` steps, expand it. The limits broadcast
    over the lanes; ``row_offset`` [B] places each lane's graph in a
    stacked corpus (node v of lane b is row ``v + row_offset[b]``).

    The loop works on the queues' occupied prefix: past its valid entries a
    sorted queue holds only the empty sentinel, and a step adds at most M0
    entries, so the first W slots (a power of two above the valid entries
    plus one step's) evolve exactly as the whole queue does. W widens as
    the queues fill; a queue sized for a whole shard (``sharded_search``'s
    resumable beams) is then never sorted at its full capacity."""
    ids, scores, stable = state.queue
    visited, steps = state.visited.clone(), state.steps.clone()
    B, C = ids.shape
    m0 = neighbors.shape[1]
    dev = ids.device
    lanes = torch.arange(B, device=dev)
    compressed = quant.is_quantized(vectors)
    qprep = quant.prepare_query(vectors, qs, metric) if compressed else None
    stable_limit = torch.as_tensor(stable_limit, device=dev).expand(B)
    min_value = torch.as_tensor(min_value, dtype=torch.float32,
                                device=dev).expand(B)
    max_steps = torch.as_tensor(max_steps, device=dev).expand(B)
    off = (None if row_offset is None else
           torch.as_tensor(row_offset, dtype=torch.int64, device=dev))
    n_valid = int((ids >= 0).sum(dim=-1).max()) if B else 0
    W = _occupied_width(n_valid + m0, C)
    ids, scores, stable = ids[:, :W], scores[:, :W], stable[:, :W]
    while True:
        if n_valid + m0 > W:   # a bound: recount, widen if it holds
            n_valid = int((ids >= 0).sum(dim=-1).max())
            if n_valid + m0 > W:
                W = _occupied_width(n_valid + m0, C)
                ids, scores, stable = qmod.grow(Queue(ids, scores, stable), W)
        p, exists = qmod.first_unstable(Queue(ids, scores, stable),
                                        stable_limit)
        run = exists & (scores[lanes, p] >= min_value) & (steps < max_steps)
        if not bool(run.any()):
            break
        node = ids[lanes, p].clamp(min=0).long()
        marked = stable.clone()
        marked[lanes, p] = stable[lanes, p] | run
        visited[lanes, node] = visited[lanes, node] | run
        nbrs = neighbors[node if off is None else node + off]   # [B, M0]
        safe = nbrs.clamp(min=0)
        fresh = (nbrs >= 0) & ~visited[lanes[:, None], safe.long()]
        rows = safe if off is None else safe + off[:, None]
        if compressed:
            sims = quant.score_rows(qprep, vectors, rows, metric)
        else:
            gather = nbrs if off is None else torch.where(
                nbrs >= 0, rows, -1).to(torch.int32)
            sims = kops.batch_similarity_gather(qs, vectors, gather, metric,
                                                impl)
        new = qmod.insert(Queue(ids, scores, marked), nbrs, sims, fresh)
        r = run[:, None]
        ids = torch.where(r, new.ids, ids)
        scores = torch.where(r, new.scores, scores)
        stable = torch.where(r, new.stable, stable)
        steps = steps + run.to(torch.int32)
        n_valid += m0
    queue = Queue(ids, scores, stable)
    return SearchState(qmod.grow(queue, C) if W < C else queue, visited,
                       steps)


def run_search(graph: FlatGraph, qs: torch.Tensor, state: SearchState,
               stable_limit, min_value=float("-inf"), max_steps=None,
               impl: str | None = None, row_offset=None) -> SearchState:
    """Run every lane's loop from ``state`` to its stop; ``max_steps``
    defaults to ``4 * capacity + 64``, as in the reference."""
    if max_steps is None:
        max_steps = 4 * state.queue.capacity + 64
    return _search_loop(graph.vectors, graph.neighbors, qs, state,
                        stable_limit, min_value, max_steps, graph.metric,
                        impl, row_offset)


def resume_search(graph: FlatGraph, qs: torch.Tensor, state: SearchState,
                  stable_limit, min_value=float("-inf"), step_budget=None,
                  impl: str | None = None, row_offset=None) -> SearchState:
    """Resume a previous ``run_search`` under a continued stable limit.

    The queue and visited set carry over, so earlier expansions are never
    redone; ``step_budget`` (default ``4 * capacity + 64``) is added to the
    steps each lane has already taken, so a resumed round gets the
    allowance a fresh one would. The reference's widening contract holds
    (``repro.core.beam_search.resume_search``): a queue at least
    ``stable_limit`` wide, or as wide as the graph, evolves its leading
    prefix as any wider queue would."""
    if step_budget is None:
        step_budget = 4 * state.queue.capacity + 64
    max_steps = state.steps + torch.as_tensor(step_budget, dtype=torch.int32,
                                              device=state.steps.device)
    return run_search(graph, qs, state, stable_limit, min_value, max_steps,
                      impl, row_offset)


def beam_search(graph: FlatGraph, q: torch.Tensor, k: int, L: int,
                capacity: int | None = None, impl: str | None = None):
    """Paper Alg. 1: plain beam search of q[d] -> (ids[k], scores[k]), or
    of q[B, d] -> (ids[B, k], scores[B, k])."""
    qs = q[None] if q.dim() == 1 else q
    state = init_state(graph, qs, capacity or L, impl)
    state = run_search(graph, qs, state, stable_limit=L, impl=impl)
    ids, scores = state.queue.ids[:, :k], state.queue.scores[:, :k]
    return (ids[0], scores[0]) if q.dim() == 1 else (ids, scores)


def progressive_beam_search(graph: FlatGraph, qs: torch.Tensor,
                            state: SearchState, K, ef: int,
                            min_value=float("-inf")) -> SearchState:
    """The paper's ProgressiveBeamSearch: resume until the first K*ef
    candidates are stable. ``max_steps`` is the absolute default of
    ``run_search``, as in the reference."""
    return run_search(graph, qs, state, stable_limit=K * ef,
                      min_value=min_value)


def rebuild_for_growth(graph: FlatGraph, qs: torch.Tensor, state: SearchState,
                       new_capacity: int) -> SearchState:
    """Exact queue rebuild when the driver grows capacity.

    Fixed capacity can silently drop (a) unexpanded frontier nodes and
    (b) expanded nodes that fell below the old capacity boundary. Expanded
    nodes are exactly the ``visited`` set, so rebuilding from (current
    queue entries) ∪ (visited nodes, rescored) reproduces the
    unbounded-queue state of the paper exactly. Every node is rescored
    (``kops.batch_similarity``, one ``sim_many`` launch over the corpus on
    the card); queue membership is an add-scatter, because several empty
    sentinels all map to node 0; ``qmod.from_entries`` sorts the members
    by (score desc, id asc)."""
    n = graph.size
    ids, _, stable = state.queue
    dev = ids.device
    all_ids = torch.arange(n, dtype=torch.int32, device=dev)
    if quant.is_quantized(graph.vectors):
        qprep = quant.prepare_query(graph.vectors, qs, graph.metric)
        vis_scores = quant.score_rows(qprep, graph.vectors,
                                      all_ids.expand(qs.shape[0], n),
                                      graph.metric)
    else:
        vis_scores = kops.batch_similarity(qs, graph.vectors, graph.metric)
    safe = ids.clamp(min=0).long()
    zeros = torch.zeros(vis_scores.shape, dtype=torch.int32, device=dev)
    in_queue = zeros.scatter_add(1, safe, (ids >= 0).to(torch.int32)) > 0
    frontier_unstable = zeros.scatter_add(
        1, safe, ((ids >= 0) & ~stable).to(torch.int32)) > 0
    member = state.visited | in_queue
    new_queue = qmod.from_entries(
        torch.where(member, all_ids, -1),
        torch.where(member, vis_scores, qmod.NEG_INF),
        ~frontier_unstable, new_capacity)
    return SearchState(new_queue, state.visited, state.steps)
