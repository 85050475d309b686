"""Progressive-search driver: host-side orchestration shared by PGS/PDS/PSS
(port of ``repro.core.progressive``).

The paper's progressive framework alternates device-side search bursts with
host-side diversification decisions (pause / inspect / resume). The driver
owns one query's state as a one-lane ``beam_search.SearchState`` and the
capacity policy: the queue has a fixed capacity, and on the rare growth
events the state is rebuilt *exactly* (``beam_search.rebuild_for_growth``)
so semantics match the unbounded queue.

``ensure_stable`` calls ``run_search``, whose ``max_steps`` is absolute
(``4 * capacity + 64`` against the steps accumulated over every call), as
the reference's does: once a query has spent it, a call expands nothing
until a growth raises the cap. The batched engine mirrors this lane for
lane (``core.batch_progressive``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import beam_search as bs
from repro_torch.core.bucketing import next_pow2 as _next_pow2
from repro_torch.core.graph import FlatGraph
from repro_torch.core.queue import stable_count as q_stable_count


@dataclasses.dataclass
class SearchStats:
    expansions: int = 0
    growths: int = 0
    search_calls: int = 0
    div_calls: int = 0
    certified: bool = False
    exhausted: bool = False
    K_final: int = 0


class ProgressiveDriver:
    """Owns one query's progressive search state across pause/resume cycles.

    ``q`` is a query vector (array or tensor); it and the state live on the
    graph's device."""

    def __init__(self, graph: FlatGraph, q, ef: int, k: int,
                 capacity0: int | None = None, max_capacity: int | None = None):
        self.graph = graph
        self.q = torch.as_tensor(q, dtype=torch.float32, device=graph.device)
        self.qs = self.q[None]       # the one lane of the search state
        self.ef = ef
        self.k = k
        n = graph.size
        if capacity0 is None:
            capacity0 = min(_next_pow2(max(2 * k * ef, 256)), _next_pow2(n))
        self.max_capacity = max_capacity or _next_pow2(n)
        self.state = bs.init_state(graph, self.qs, capacity0)
        self.stats = SearchStats()

    @property
    def capacity(self) -> int:
        return self.state.queue.capacity

    def _grow_to(self, cap: int) -> None:
        cap = min(_next_pow2(cap), self.max_capacity)
        if cap <= self.capacity:
            return
        self.state = bs.rebuild_for_growth(self.graph, self.qs, self.state,
                                           cap)
        self.stats.growths += 1

    def ensure_stable(self, target: int, min_value=-np.inf) -> int:
        """Resume search until the first ``target`` candidates are stable
        (or expansion scores drop below ``min_value`` / graph exhausts /
        the absolute step cap is spent). Returns the stable prefix length."""
        target = int(min(target, self.graph.size))
        if target + 8 > self.capacity:
            self._grow_to(int(target * 1.5) + 64)
        steps_before = int(self.state.steps[0])
        self.state = bs.run_search(self.graph, self.qs, self.state,
                                   stable_limit=min(target, self.capacity),
                                   min_value=min_value)
        self.stats.search_calls += 1
        self.stats.expansions += int(self.state.steps[0]) - steps_before
        return self.stable_prefix_len()

    def expand_until_below(self, min_value: float) -> int:
        """PSS's ProgressiveBeamSearch*: expand while the frontier score is
        >= min_value; grows capacity as needed. Returns stable count."""
        while True:
            stable = self.ensure_stable(self.capacity, min_value=min_value)
            # done if frontier dropped below min_value or graph exhausted
            if stable < self.capacity or self.capacity >= self.max_capacity:
                return stable
            self._grow_to(self.capacity * 2)

    def prefix(self, K: int) -> tuple[torch.Tensor, torch.Tensor]:
        """First K candidate (ids, scores), padded to a shape bucket.

        Entries beyond K are masked out (id=-1, score=-inf) so downstream
        consumers see exactly the first-K semantics; the padded width,
        min(max(64, next_pow2(K)), capacity), is the reference's bucket: it
        sets the widths the kernels launch at and the span of PDS's and
        PSS's prefix comparisons.
        """
        K = int(min(K, self.capacity))
        bucket = min(max(64, _next_pow2(K)), self.capacity)
        ids = self.state.queue.ids[0, :bucket]
        scores = self.state.queue.scores[0, :bucket]
        keep = torch.arange(bucket, device=ids.device) < K
        return (torch.where(keep, ids, -1),
                torch.where(keep, scores, float("-inf")))

    def stable_prefix_len(self) -> int:
        return int(q_stable_count(self.state.queue)[0])
