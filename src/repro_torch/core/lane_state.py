"""Lane-state layer: fixed-shape per-lane search state for the batched engine.

Port of ``repro.core.lane_state``. A *lane* is one slot of the batched
progressive engine: a fixed-capacity candidate queue, a visited set and a
step counter — ``beam_search.SearchState`` with a leading lane axis on every
tensor. All lanes share one physical queue width; each lane's *logical*
capacity is enforced by the engine's clamp, so padding with the empty-slot
sentinel (id=-1, score=-inf, stable=True) never changes lane semantics.

Updates return new tensors (the reference is functional); nothing here
writes into a state the caller still holds.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import beam_search as bs
from repro_torch.core import queue as qmod
from repro_torch.core.graph import FlatGraph


def pad_queue(queue: qmod.Queue, pad: int) -> qmod.Queue:
    """Extend a queue's last axis with empty-slot sentinels."""
    if pad == 0:
        return queue
    fill = qmod.make_queue(pad, tuple(queue.ids.shape[:-1]), queue.ids.device)
    return qmod.Queue(*(torch.cat([a, b], -1) for a, b in zip(queue, fill)))


def physical_capacity(state: bs.SearchState) -> int:
    return int(state.queue.ids.shape[-1])


def pad_lanes(state: bs.SearchState, new_capacity: int) -> bs.SearchState:
    """Grow the shared physical queue width (logical capacities unchanged)."""
    pad = new_capacity - physical_capacity(state)
    if pad <= 0:
        return state
    return bs.SearchState(pad_queue(state.queue, pad), state.visited,
                          state.steps)


def slice_queue_capacity(state: bs.SearchState, cap: int) -> bs.SearchState:
    """View of the lanes at queue width ``cap`` (<= physical capacity)."""
    q = state.queue
    return bs.SearchState(
        qmod.Queue(q.ids[..., :cap], q.scores[..., :cap], q.stable[..., :cap]),
        state.visited, state.steps)


def init_lanes(graph: FlatGraph, qs: torch.Tensor, capacity: int,
               impl: str | None = None) -> bs.SearchState:
    """Batched ``beam_search.init_state`` over a query batch."""
    return bs.init_state(graph, qs, capacity, impl=impl)


def _map(fn, state: bs.SearchState, *others) -> bs.SearchState:
    q = qmod.Queue(*(fn(a, *(o.queue[i] for o in others))
                     for i, a in enumerate(state.queue)))
    return bs.SearchState(q, fn(state.visited, *(o.visited for o in others)),
                          fn(state.steps, *(o.steps for o in others)))


def extract_lane(state: bs.SearchState, lane: int) -> bs.SearchState:
    """One lane's state as a solo ``SearchState``."""
    return _map(lambda a: a[lane], state)


def _set_lane(lane):
    def put(a, v):
        out = a.clone()
        out[lane] = v
        return out
    return put


def inject_lane(state: bs.SearchState, lane: int,
                lane_state: bs.SearchState) -> bs.SearchState:
    """Replace one lane's state; sibling lanes are untouched."""
    return _map(_set_lane(lane), state, lane_state)


def recycle_lane(graph: FlatGraph, state: bs.SearchState, lane: int, q,
                 impl: str | None = None) -> bs.SearchState:
    """Re-initialize lane ``lane`` for a new query ``q``: the slot becomes
    exactly what a fresh solo driver starts from, at the batch's physical
    capacity; all other lanes keep their bits."""
    q = torch.as_tensor(np.asarray(q, np.float32), device=graph.device)
    fresh = bs.init_state(graph, q[None], physical_capacity(state), impl=impl)
    return inject_lane(state, lane, extract_lane(fresh, 0))


def select_lanes(state: bs.SearchState, lanes) -> bs.SearchState:
    """Gather a sub-batch of lanes (used for bucketed rebuilds)."""
    idx = torch.as_tensor(np.asarray(lanes), dtype=torch.long,
                          device=state.visited.device)
    return _map(lambda a: a[idx], state)


def from_host(state, device=None) -> bs.SearchState:
    """Lane state from the reference's ``lane_state.init_lanes`` output as
    numpy: a nested ``((ids, scores, stable), visited, steps)`` (the
    reference's ``SearchState(Queue(...), visited, steps)`` after
    ``np.asarray`` on each leaf). Both packages then start from one state."""
    (ids, scores, stable), visited, steps = state
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(dev, dtype)

    return bs.SearchState(
        qmod.Queue(t(ids, torch.int32), t(scores, torch.float32),
                   t(stable, torch.bool)),
        t(visited, torch.bool), t(steps, torch.int32))
