"""Fixed-capacity candidate queue (the paper's ``C``), in PyTorch.

Port of ``repro.core.queue``. A queue is sorted by (score desc, id asc):

  ids    int32[..., C]   (-1 = empty slot)
  scores f32[..., C]     (-inf for empty slots)
  stable bool[..., C]    (True = already expanded; padding is marked stable)

Every function takes optional leading lane axes, which stand in for the
reference's ``vmap``: each lane's result is computed from that lane alone.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = float("-inf")


class Queue(NamedTuple):
    ids: torch.Tensor     # int32[..., C]
    scores: torch.Tensor  # float32[..., C]
    stable: torch.Tensor  # bool[..., C]

    @property
    def capacity(self) -> int:
        return self.ids.shape[-1]


def make_queue(capacity: int, lanes: tuple = (), device=None) -> Queue:
    shape = (*lanes, capacity)
    return Queue(
        ids=torch.full(shape, -1, dtype=torch.int32, device=device),
        scores=torch.full(shape, NEG_INF, dtype=torch.float32, device=device),
        stable=torch.ones(shape, dtype=torch.bool, device=device),
    )


def _sort_desc(ids: torch.Tensor, scores: torch.Tensor, stable: torch.Tensor):
    """Deterministic descending sort by (score desc, id asc) on the last axis."""
    # lexsort with two stable passes: secondary key (id asc) first, then the
    # primary key (score desc); empty slots (-1, -inf) sink to the back.
    o1 = torch.sort(ids, dim=-1, stable=True).indices
    s1 = torch.gather(scores, -1, o1)
    o2 = torch.sort(s1, dim=-1, descending=True, stable=True).indices
    order = torch.gather(o1, -1, o2)
    return (torch.gather(ids, -1, order), torch.gather(scores, -1, order),
            torch.gather(stable, -1, order))


def sort_queue(q: Queue) -> Queue:
    return Queue(*_sort_desc(q.ids, q.scores, q.stable))


def dedup_candidates(q: Queue, new_ids: torch.Tensor, new_scores: torch.Tensor,
                     new_mask: torch.Tensor):
    """Shared candidate masking for insert implementations.

    Candidates already in the queue, duplicated within the incoming batch
    (first occurrence wins), masked out, or invalid (< 0) become the empty
    sentinel (-1, -inf, stable). Shapes: ``new_*`` [..., M] against the
    queue's [..., C].
    """
    dup = torch.any(new_ids[..., :, None] == q.ids[..., None, :], dim=-1)
    m = new_ids.shape[-1]
    ar = torch.arange(m, device=new_ids.device)
    earlier = ((new_ids[..., :, None] == new_ids[..., None, :])
               & (ar[None, :] < ar[:, None]))
    dup = dup | torch.any(earlier & new_mask[..., None, :], dim=-1)
    keep = new_mask & ~dup & (new_ids >= 0)
    return (torch.where(keep, new_ids, -1).to(torch.int32),
            torch.where(keep, new_scores.to(torch.float32),
                        torch.full_like(new_scores, NEG_INF, dtype=torch.float32)),
            ~keep)


def insert(q: Queue, new_ids: torch.Tensor, new_scores: torch.Tensor,
           new_mask: torch.Tensor) -> Queue:
    """Insert a batch of candidates, dedup against the queue, truncate to
    capacity. New entries arrive unstable."""
    cap = q.capacity
    ids, scores, stable = dedup_candidates(q, new_ids, new_scores, new_mask)
    i, s, st = _sort_desc(torch.cat([q.ids, ids], -1),
                          torch.cat([q.scores, scores], -1),
                          torch.cat([q.stable, stable], -1))
    return Queue(i[..., :cap], s[..., :cap], st[..., :cap])


def first_unstable(q: Queue, limit) -> tuple[torch.Tensor, torch.Tensor]:
    """Index of the first unstable valid entry among the first ``limit``
    slots, per lane. Returns (p int64[...], exists bool[...])."""
    pos = torch.arange(q.capacity, device=q.ids.device)
    limit = torch.as_tensor(limit, device=q.ids.device)
    mask = (~q.stable) & (q.ids >= 0) & (pos < limit[..., None])
    exists = torch.any(mask, dim=-1)
    p = torch.argmax(mask.to(torch.int8), dim=-1)  # first True
    return p, exists


def stable_count(q: Queue) -> torch.Tensor:
    """Number of leading entries that are stable and valid (the paper's K*ef)."""
    ok = q.stable & (q.ids >= 0)
    return torch.sum(torch.cumprod(ok.to(torch.int32), dim=-1), dim=-1)


def valid_count(q: Queue) -> torch.Tensor:
    return torch.sum(q.ids >= 0, dim=-1)


def grow(q: Queue, new_capacity: int) -> Queue:
    """Return a copy with larger capacity (host-side driver utility)."""
    if new_capacity < q.capacity:
        raise ValueError("grow cannot shrink a queue")
    pad = make_queue(new_capacity - q.capacity, tuple(q.ids.shape[:-1]),
                     q.ids.device)
    return Queue(*(torch.cat([a, b], -1) for a, b in zip(q, pad)))


def from_entries(ids: torch.Tensor, scores: torch.Tensor, stable: torch.Tensor,
                 capacity: int) -> Queue:
    """Build a queue of the given capacity from (possibly unsorted) entries."""
    n = ids.shape[-1]
    if n < capacity:
        pad = make_queue(capacity - n, tuple(ids.shape[:-1]), ids.device)
        ids = torch.cat([ids.to(torch.int32), pad.ids], -1)
        scores = torch.cat([scores.to(torch.float32), pad.scores], -1)
        stable = torch.cat([stable, pad.stable], -1)
    i, s, st = _sort_desc(ids, scores, stable)
    return Queue(i[..., :capacity], s[..., :capacity], st[..., :capacity])
