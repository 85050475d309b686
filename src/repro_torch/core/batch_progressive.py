"""Batched progressive engine (paper Alg. 2-4 over a lane batch), in PyTorch.

Port of ``repro.core.batch_progressive``: ``BatchProgressiveDriver``,
``ProgressiveEngine`` (with ``prewarm``), ``batch_pgs``, ``batch_pds``,
``batch_pss`` and ``SignatureLog``. Each lane carries its own ``(k, eps,
ef)`` and method; ``ProgressiveEngine.step()`` advances every occupied lane
one progressive round, and per-lane results match the reference engine.

Where the device work goes (each stage batched over the lanes in it):

* **Burst** (``_batched_search_loop``) — the reference runs one
  ``while_loop`` per lane under ``lax.map``. Here all lanes step in lockstep
  under a per-lane active mask: every expansion is one launch for all lanes
  of each op, with ``kernels.ops.batch_similarity_gather`` scoring each
  lane's M0 neighbour rows. A lane whose loop has stopped keeps its bits, so
  each lane's result is the one a solo run gives.
* **Growth rebuild** (``_rebuild_lanes``) — rescoring the corpus with
  ``kernels.ops.batch_similarity`` and a stable descending sort, which breaks
  ties lower index first as ``lax.top_k`` does.
* **PGS round** — one ``kernels.ops.fused_round_batch`` call per prefix group.
* **PSS verify** — ``kernels.ops.pairwise_adjacency_batch`` per group, then
  div-A* as a host loop per lane (``core.div_astar``) and Theorem 2.

The engine is float-only (``compressed`` is False). ``kernel_impl`` picks the
rung of every op ("auto", "cuda" or "ref"); the reference's
``jit_cache_sizes`` has no meaning here, and ``SignatureLog`` records the
shape classes the engine issues.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import div_astar as da
from repro_torch.core import lane_state
from repro_torch.core import queue as qmod
from repro_torch.core.backend import LaneRequest
from repro_torch.core.beam_search import SearchState
from repro_torch.core.bucketing import (next_pow2 as _next_pow2, pow2_group_sizes,
                                        pow2_padded_indices)
from repro_torch.core.diversity_graph import degrees as _degrees
from repro_torch.core.graph import FlatGraph
from repro_torch.core.pgs import DiverseResult
from repro_torch.core.progressive import SearchStats
from repro_torch.core.theorems import theorem1_K, theorem2_min_value
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import mask_prefix as _mask_prefix

NEG_INF = float("-inf")


# --------------------------------------------------------------- results ----

@dataclasses.dataclass
class BatchSearchStats:
    """Per-lane counters mirroring ``progressive.SearchStats``."""
    expansions: np.ndarray
    growths: np.ndarray
    search_calls: np.ndarray
    div_calls: np.ndarray
    certified: np.ndarray
    exhausted: np.ndarray
    K_final: np.ndarray

    @classmethod
    def zeros(cls, b: int) -> "BatchSearchStats":
        return cls(expansions=np.zeros(b, np.int64),
                   growths=np.zeros(b, np.int64),
                   search_calls=np.zeros(b, np.int64),
                   div_calls=np.zeros(b, np.int64),
                   certified=np.zeros(b, bool),
                   exhausted=np.zeros(b, bool),
                   K_final=np.zeros(b, np.int64))

    def reset_lane(self, lane: int) -> None:
        for f in dataclasses.fields(self):
            getattr(self, f.name)[lane] = 0

    def lane_view(self, lane: int) -> SearchStats:
        return SearchStats(expansions=int(self.expansions[lane]),
                           growths=int(self.growths[lane]),
                           search_calls=int(self.search_calls[lane]),
                           div_calls=int(self.div_calls[lane]),
                           certified=bool(self.certified[lane]),
                           exhausted=bool(self.exhausted[lane]),
                           K_final=int(self.K_final[lane]))


class BatchDiverseResult(NamedTuple):
    ids: np.ndarray      # int32[B, k], -1 padded
    scores: np.ndarray   # f32[B, k]
    totals: np.ndarray   # f32[B]
    stats: BatchSearchStats


# ------------------------------------------------------ signature logging ----

class SignatureBudgetExceeded(RuntimeError):
    """The engine would issue more distinct signatures than allowed."""


class SignatureLog:
    """Registry of the shape classes the engine has issued.

    A *signature* is the (call site, shape) tuple of one batched stage:
    e.g. ``("search", B, C)`` for the burst or ``("div_astar", group,
    width, k)`` for verification. ``note`` raises ``SignatureBudgetExceeded``
    once more than ``limit`` distinct signatures exist; after ``freeze()``
    first-seen signatures are also recorded in ``unplanned``.
    """

    def __init__(self, limit: int | None = 1024):
        self.limit = limit
        self.counts: dict[tuple, int] = {}
        self.frozen = False
        self.unplanned: list[tuple] = []

    def note(self, kind: str, *shape) -> None:
        sig = (kind, *(int(s) for s in shape))
        if sig not in self.counts:
            if self.limit is not None and len(self.counts) >= self.limit:
                raise SignatureBudgetExceeded(
                    f"signature {sig} would exceed the budget of "
                    f"{self.limit} distinct signatures")
            self.counts[sig] = 0
            if self.frozen:
                self.unplanned.append(sig)
        self.counts[sig] += 1

    def freeze(self) -> None:
        self.frozen = True

    def __len__(self) -> int:
        return len(self.counts)


# ------------------------------------------------------- device functions ----

def _merge_insert(queue: qmod.Queue, new_ids: torch.Tensor,
                  new_scores: torch.Tensor, new_mask: torch.Tensor) -> qmod.Queue:
    """Bit-identical replacement for ``queue.insert`` on already-sorted
    queues [B, C] with candidates [B, M]: each entry's merged position is its
    rank under the (score desc, id asc) order, from vectorized comparison
    matrices. Ties (only the empty-slot sentinel) resolve queue-first /
    index-order, matching the stable lexsort exactly."""
    cap = queue.capacity
    m = new_ids.shape[-1]
    dev = new_ids.device
    b_ids, b_scores, b_stable = qmod.dedup_candidates(
        queue, new_ids, new_scores, new_mask)
    a_ids, a_scores = queue.ids, queue.scores

    def before(s1, i1, s2, i2):
        # strict (score desc, id asc) precedence
        return (s1 > s2) | ((s1 == s2) & (i1 < i2))

    ar = torch.arange(m, device=dev)
    # rank of each b among b (strict order; sentinel ties resolve by index)
    bi_, bj_ = b_ids[..., :, None], b_ids[..., None, :]
    si_, sj_ = b_scores[..., :, None], b_scores[..., None, :]
    bb = before(si_, bi_, sj_, bj_)
    tie_bb = (si_ == sj_) & (bi_ == bj_) & (ar[:, None] < ar[None, :])
    rank_b = torch.sum(bb | tie_bb, dim=-2)
    inv_rank = torch.argmax(
        (rank_b[..., :, None] == ar[None, :]).to(torch.int8), dim=-2)
    bs_ids = torch.gather(b_ids, -1, inv_rank)
    bs_scores = torch.gather(b_scores, -1, inv_rank)
    bs_stable = torch.gather(b_stable, -1, inv_rank)
    # merged slot of each sorted-b element: a entries ahead of it (ties:
    # queue entries first), plus its own rank among b
    a_s, a_i = a_scores[..., :, None], a_ids[..., :, None]
    b_s, b_i = bs_scores[..., None, :], bs_ids[..., None, :]
    a_before_b = before(a_s, a_i, b_s, b_i) | ((a_s == b_s) & (a_i == b_i))
    pos_b = torch.sum(a_before_b, dim=-2) + ar
    # slot-wise gather: slot r holds b_sorted[cb[r]] if some b lands at r,
    # else a[r - cb[r]]
    slots = torch.arange(cap, device=dev)
    cb = torch.sum(pos_b[..., None, :] < slots[:, None], dim=-1)
    is_b = torch.any(pos_b[..., None, :] == slots[:, None], dim=-1)
    ai = torch.clamp(slots - cb, max=cap - 1)
    bi = torch.clamp(cb, max=m - 1)
    return qmod.Queue(
        ids=torch.where(is_b, torch.gather(bs_ids, -1, bi),
                        torch.gather(a_ids, -1, ai)),
        scores=torch.where(is_b, torch.gather(bs_scores, -1, bi),
                           torch.gather(a_scores, -1, ai)),
        stable=torch.where(is_b, torch.gather(bs_stable, -1, bi),
                           torch.gather(queue.stable, -1, ai)),
    )


def _batched_search_loop(vectors, neighbors, qs, state: SearchState, caps,
                         stable_limits, min_values, max_steps, metric: str,
                         impl: str | None = None) -> SearchState:
    """One burst: every lane runs its beam-search loop to its own stop.

    The lanes advance in lockstep: each iteration expands the first
    unstable entry of every lane still running (exists & frontier score >=
    its min_value & steps < its max_steps), scores the expanded node's
    neighbour rows with one gathered-similarity launch for all lanes, merges
    them into each queue and clamps it to the lane's logical capacity
    (entries at positions >= cap return to the empty sentinel). Lanes that
    have stopped keep their state bit for bit.
    """
    ids, scores, stable = state.queue
    visited, steps = state.visited.clone(), state.steps.clone()
    B, C = ids.shape
    dev = ids.device
    lanes = torch.arange(B, device=dev)
    pos = torch.arange(C, device=dev)[None, :]
    live = pos < caps[:, None]
    in_limit = pos < stable_limits[:, None]

    def first_unstable(ids, stable):  # qmod.first_unstable, limit hoisted
        mask = ~stable & (ids >= 0) & in_limit
        return torch.argmax(mask.to(torch.int8), dim=1), torch.any(mask, dim=1)

    p, exists = first_unstable(ids, stable)
    while True:
        run = (exists & (scores[lanes, p] >= min_values)
               & (steps < max_steps))
        if not bool(run.any()):
            break
        node = ids[lanes, p].clamp(min=0).long()
        marked = stable.clone()
        marked[lanes, p] = stable[lanes, p] | run
        visited[lanes, node] = visited[lanes, node] | run
        nbrs = neighbors[node]
        safe = nbrs.clamp(min=0).long()
        fresh = (nbrs >= 0) & ~visited[lanes[:, None], safe]
        sims = kops.batch_similarity_gather(qs, vectors, nbrs, metric, impl)
        merged = _merge_insert(qmod.Queue(ids, scores, marked), nbrs, sims,
                               fresh)
        r = run[:, None] & live
        keep = run[:, None] & ~live
        ids = torch.where(r, merged.ids, torch.where(keep, -1, ids))
        scores = torch.where(r, merged.scores,
                             torch.where(keep, NEG_INF, scores))
        stable = torch.where(r, merged.stable, torch.where(keep, True, stable))
        steps = steps + run.to(torch.int32)
        p, exists = first_unstable(ids, stable)
    return SearchState(qmod.Queue(ids, scores, stable), visited, steps)


def _rebuild_lanes(graph: FlatGraph, qs, state: SearchState, new_capacity: int,
                   impl: str | None = None) -> SearchState:
    """Exact rebuild of a growth bucket's lanes: rescore (visited ∪ queue)
    against the whole corpus and keep the best ``new_capacity``.

    The reference selects with ``lax.top_k``, whose ties go lower index
    first; ``torch.topk`` promises no tie order, so this takes a stable
    descending sort on the node-indexed scores, which orders (score desc,
    id asc) exactly. Queue membership is an add-scatter, because several
    empty sentinels all map to node 0.
    """
    n = graph.size
    k0 = min(new_capacity, n)
    ids, _, stable = state.queue
    vis_scores = kops.batch_similarity(qs, graph.vectors, graph.metric, impl)
    safe = ids.clamp(min=0).long()
    zeros = torch.zeros(vis_scores.shape, dtype=torch.int32, device=ids.device)
    in_queue = zeros.scatter_add(1, safe, (ids >= 0).to(torch.int32)) > 0
    frontier_unstable = zeros.scatter_add(
        1, safe, ((ids >= 0) & ~stable).to(torch.int32)) > 0
    member = state.visited | in_queue
    scores = torch.where(member, vis_scores, NEG_INF)
    top_scores, sel = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, sel = top_scores[:, :k0], sel[:, :k0]
    valid = top_scores > NEG_INF  # similarities are always finite
    queue = lane_state.pad_queue(qmod.Queue(
        ids=torch.where(valid, sel.to(torch.int32), -1),
        scores=torch.where(valid, top_scores, NEG_INF),
        stable=torch.where(valid, ~torch.gather(frontier_unstable, 1, sel),
                           True)), new_capacity - k0)
    return SearchState(queue, state.visited, state.steps)


def _batched_adjacency(vectors, ids, eps, metric: str, impl=None):
    """Per-lane G^eps adjacency; ``eps`` is a per-lane f32 vector."""
    return kops.pairwise_adjacency_batch(vectors, ids, eps, metric, impl)


def _batched_div_astar(scores: torch.Tensor, adj: torch.Tensor, k: int,
                       max_expansions: int):
    """div-A* + Theorem-2 minValue per lane, on the host.

    One copy off the device per group, then one sequential branch-and-bound
    per lane (``core.div_astar``). Returns (best_sets int32[G, k, k],
    best_scores f32[G, k], complete bool[G], min_values f32[G]).
    """
    sc = scores.cpu().numpy()
    adj_np = adj.cpu().numpy()
    res = [da.div_astar(s, a, k, max_expansions) for s, a in zip(sc, adj_np)]
    best_scores = np.stack([r.best_scores for r in res])
    mv = theorem2_min_value(torch.from_numpy(best_scores), k).numpy()
    return (np.stack([r.best_sets for r in res]), best_scores,
            np.array([r.complete for r in res]), mv)


def _batched_theorem1(adj, valid, k: int):
    """Theorem-1 sufficient candidate count per lane (PDS degree schedule)."""
    return theorem1_K(_degrees(adj, valid), k)


# ----------------------------------------------------------------- driver ----

class BatchProgressiveDriver:
    """Owns a whole batch's lane state across pause/resume.

    Mirrors the reference lane for lane: the same capacity policy, growth
    thresholds and stop conditions applied to every lane individually (as
    host-side numpy vectors). ``kernel_impl`` picks the rung of the burst,
    rebuild and entry scoring ("auto", "cuda" or "ref").
    """

    def __init__(self, graph: FlatGraph, qs, ef: int, k: int,
                 capacity0: int | None = None,
                 max_capacity: int | None = None,
                 max_signatures: int | None = 1024,
                 kernel_impl: str | None = None):
        self.graph = graph
        self.kernel_impl = kernel_impl
        self.qs = torch.as_tensor(qs, dtype=torch.float32,
                                  device=graph.device).contiguous()
        self.B = int(self.qs.shape[0])
        self.ef = ef
        self.k = k
        n = graph.size
        if capacity0 is None:
            capacity0 = min(_next_pow2(max(2 * k * ef, 256)), _next_pow2(n))
        self.max_capacity = max_capacity or _next_pow2(n)
        self.caps = np.full(self.B, capacity0, np.int64)
        self.signatures = SignatureLog(max_signatures)
        self.signatures.note("init", self.B, capacity0)
        self.state = lane_state.init_lanes(graph, self.qs, capacity0,
                                           impl=kernel_impl)
        self.stats = BatchSearchStats.zeros(self.B)

    def _t(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.graph.device, dtype)

    # -- capacity management ------------------------------------------------
    @property
    def physical_capacity(self) -> int:
        return lane_state.physical_capacity(self.state)

    def _ensure_physical(self, cap: int) -> None:
        self.state = lane_state.pad_lanes(self.state, cap)

    def recycle(self, lane: int, q, capacity0: int) -> None:
        """Hand lane ``lane`` to a new query: fresh solo-equivalent state at
        logical capacity ``capacity0``, stats zeroed, siblings untouched."""
        self._ensure_physical(capacity0)
        self.signatures.note("recycle", self.B, self.physical_capacity)
        self.state = lane_state.recycle_lane(self.graph, self.state, lane, q,
                                             impl=self.kernel_impl)
        qs = self.qs.clone()
        qs[lane] = self._t(np.asarray(q, np.float32), torch.float32)
        self.qs = qs
        self.caps[lane] = capacity0
        self.stats.reset_lane(lane)

    def _grow_lanes(self, req: np.ndarray, mask: np.ndarray) -> None:
        """Grow each masked lane to next_pow2(req) (clamped), per bucket.

        Lanes landing on the same power-of-two bucket are rebuilt together
        in one exact rebuild (the reference pads the bucket to a power-of-two
        lane count for its compile cache; the signature log records that
        padded count, while only the real lanes are computed here).
        """
        targets = np.array([min(_next_pow2(int(r)), self.max_capacity)
                            for r in req])
        grow = mask & (targets > self.caps)
        if not grow.any():
            return
        self._ensure_physical(int(targets[grow].max()))
        C = self.physical_capacity
        for cap in sorted(set(int(c) for c in targets[grow])):
            idx = np.flatnonzero(grow & (targets == cap))
            sub = lane_state.select_lanes(self.state, idx)
            sub = lane_state.slice_queue_capacity(sub, cap)
            self.signatures.note("rebuild", len(pow2_padded_indices(idx)), cap)
            ridx = self._t(idx, torch.long)
            rebuilt = _rebuild_lanes(self.graph, self.qs[ridx], sub, cap,
                                     self.kernel_impl)
            q = lane_state.pad_queue(rebuilt.queue, C - cap)
            bq = self.state.queue
            new = []
            for old, part in zip(bq, q):
                t = old.clone()
                t[ridx] = part
                new.append(t)
            self.state = SearchState(qmod.Queue(*new), self.state.visited,
                                     self.state.steps)
            self.caps[idx] = cap
            self.stats.growths[idx] += 1

    # -- search bursts ------------------------------------------------------
    def ensure_stable(self, targets: np.ndarray,
                      min_values: np.ndarray | None = None,
                      active: np.ndarray | None = None) -> np.ndarray:
        """Resume every active lane until its first ``targets[i]`` candidates
        are stable (or its frontier drops below ``min_values[i]``).
        Returns the per-lane stable prefix length."""
        n = self.graph.size
        if active is None:
            active = np.ones(self.B, bool)
        if not active.any():
            return self.stable_prefix_len()
        targets = np.minimum(np.asarray(targets, np.int64), n)
        need = active & (targets + 8 > self.caps)
        self._grow_lanes((targets * 1.5).astype(np.int64) + 64, need)
        if min_values is None:
            min_values = np.full(self.B, -np.inf, np.float32)
        sl = np.where(active, np.minimum(targets, self.caps), 0)
        ms = 4 * self.caps + 64
        self.signatures.note("search", self.B, self.physical_capacity)
        self.state = _batched_search_loop(
            self.graph.vectors, self.graph.neighbors, self.qs, self.state,
            self._t(self.caps, torch.int32), self._t(sl, torch.int32),
            self._t(np.asarray(min_values, np.float32), torch.float32),
            self._t(ms, torch.int32), self.graph.metric, self.kernel_impl)
        self.stats.search_calls[active] += 1
        self.stats.expansions = self.state.steps.cpu().numpy().astype(np.int64)
        return self.stable_prefix_len()

    def expand_until_below(self, min_values: np.ndarray,
                           active: np.ndarray) -> np.ndarray:
        """PSS's ProgressiveBeamSearch* per lane: expand while the frontier
        score is >= minValue, growing capacity as needed."""
        stable = np.zeros(self.B, np.int64)
        remaining = active.copy()
        while remaining.any():
            got = self.ensure_stable(np.where(remaining, self.caps, 0),
                                     min_values, remaining)
            stable[remaining] = got[remaining]
            done = (stable < self.caps) | (self.caps >= self.max_capacity)
            remaining = remaining & ~done
            if remaining.any():
                self._grow_lanes(self.caps * 2, remaining)
        return stable

    def stable_prefix_len(self) -> np.ndarray:
        return qmod.stable_count(self.state.queue).cpu().numpy().astype(np.int64)

    # -- candidate prefixes -------------------------------------------------
    def _buckets(self, Ks: np.ndarray) -> np.ndarray:
        return np.minimum(
            np.maximum(64, np.array([_next_pow2(int(K)) for K in Ks])),
            self.caps)

    def _group_lanes(self, Ks: np.ndarray, active: np.ndarray, ks=None):
        """Group active lanes by (width bucket[, k]). Yields (lane_indices,
        width, lane index tensor, Ks of those lanes). The reference pads each
        group to a power-of-two lane count with all-sentinel rows for its
        compile cache; here only the real lanes are computed."""
        Ks = np.minimum(np.asarray(Ks, np.int64), self.caps)
        buckets = self._buckets(Ks)
        groups: dict[tuple, list[int]] = {}
        for i in np.flatnonzero(active):
            key = (int(buckets[i]), -1 if ks is None else int(ks[i]))
            groups.setdefault(key, []).append(i)
        for (width, _k), idx in sorted(groups.items()):
            idx = np.asarray(idx)
            yield idx, width, self._t(idx, torch.long), Ks[idx]

    def prefix_groups(self, Ks: np.ndarray, active: np.ndarray, ks=None):
        """Yield (lane_indices, ids, scores) per (width bucket[, k]) group,
        masked so positions >= K carry the id=-1 / -inf sentinels. Each lane
        runs at its own bucket width, which keeps div-A*'s step accounting
        identical to the reference."""
        for idx, width, jidx, Ks_g in self._group_lanes(Ks, active, ks):
            self.signatures.note("prefix", _next_pow2(len(idx)), width)
            ids, scores = _mask_prefix(
                self.state.queue.ids[jidx, :width],
                self.state.queue.scores[jidx, :width],
                self._t(Ks_g, torch.int32))
            yield idx, ids, scores

    def prefix_groups_raw(self, Ks: np.ndarray, active: np.ndarray, ks=None):
        """Like ``prefix_groups`` but yields the raw queue rows plus the
        per-lane budgets (lane_indices, ids, scores, Ks), for the fused
        round, which masks the prefix itself."""
        for idx, width, jidx, Ks_g in self._group_lanes(Ks, active, ks):
            yield (idx, self.state.queue.ids[jidx, :width],
                   self.state.queue.scores[jidx, :width], Ks_g)


# ----------------------------------------------------------------- engine ----

LANE_FREE, LANE_PGS, LANE_PSS, LANE_PDS, LANE_PDS_FIN, LANE_DONE = range(6)

_METHOD_STATUS = {"pss": LANE_PGS, "pgs": LANE_PGS, "pds": LANE_PDS}


class ProgressiveEngine:
    """Per-lane progressive state machine over a ``BatchProgressiveDriver``.

    Each lane independently runs one of the paper's methods with its own
    ``(k, eps, ef)``:

    * ``pgs``  — Alg. 2 rounds: stabilize K*ef, greedy-diversify, grow K.
    * ``pss``  — Alg. 4: the PGS warm start, then div-A* + Theorem-2
      certificate rounds with ProgressiveBeamSearch* resumption.
    * ``pds``  — Alg. 3: Theorem-1 degree schedule rounds, then one
      certified div-A*.

    ``step()`` advances every occupied lane one round and returns the lanes
    that finished; finished lanes can be re-admitted with a new query via
    ``admit``. ``kernel_impl`` ("auto", "cuda", "ref" or None for the
    ``kernels.ops`` default) picks the rung of every op the engine runs.
    The reference's ``swap_graph`` and ``record_candidates`` serve the
    mutable index and the result cache, and come with their slice.
    """

    methods = ("pss", "pgs", "pds")

    def __init__(self, graph: FlatGraph, num_lanes: int | None = None, *,
                 driver: BatchProgressiveDriver | None = None,
                 max_k: int = 16, default_ef: int = 40,
                 capacity0: int | None = None,
                 max_capacity: int | None = None,
                 max_iters: int = 64, max_expansions: int = 400_000,
                 max_signatures: int | None = 1024,
                 kernel_impl: str | None = None):
        self.graph = graph
        self.kernel_impl = kernel_impl
        if driver is None:
            if num_lanes is None:
                raise ValueError("need num_lanes or driver")
            base_cap = capacity0 or min(256, _next_pow2(graph.size))
            driver = BatchProgressiveDriver(
                graph, torch.zeros((num_lanes, graph.dim), device=graph.device),
                ef=default_ef, k=1, capacity0=base_cap,
                max_capacity=max_capacity, max_signatures=max_signatures,
                kernel_impl=kernel_impl)
        self.driver = driver
        self.B = driver.B
        self.max_k = max_k
        self.default_ef = default_ef
        self._capacity0 = capacity0
        self._max_capacity = max_capacity
        self._max_signatures = max_signatures
        self.max_iters = max_iters
        self.max_expansions = max_expansions
        self.status = np.full(self.B, LANE_FREE, np.int8)
        self.to_pss = np.zeros(self.B, bool)
        self.ks = np.full(self.B, 1, np.int64)
        self.epss = np.zeros(self.B, np.float64)
        self.efs = np.full(self.B, default_ef, np.int64)
        self.K = np.zeros(self.B, np.int64)
        self.iters = np.zeros(self.B, np.int64)
        self.maxK = np.full(self.B, graph.size, np.int64)
        self.out_ids = np.full((self.B, max_k), -1, np.int32)
        self.out_sc = np.zeros((self.B, max_k), np.float32)
        self._unharvested: list[int] = []
        # the engine scores the exact float corpus only
        self.compressed = False

    # -- admission ----------------------------------------------------------
    @property
    def num_lanes(self) -> int:
        return self.B

    @property
    def bytes_per_vector(self) -> float:
        """Stored corpus bytes per vector (f32 graph: ``4 * d``)."""
        return float(4 * self.graph.dim)

    @property
    def signatures(self) -> SignatureLog:
        return self.driver.signatures

    @property
    def signature_log(self) -> SignatureLog:
        return self.driver.signatures

    def free_lanes(self) -> np.ndarray:
        return np.flatnonzero((self.status == LANE_FREE)
                              | (self.status == LANE_DONE))

    def active_count(self) -> int:
        return int(((self.status != LANE_FREE)
                    & (self.status != LANE_DONE)).sum())

    def _set_lane(self, lane: int, k: int, eps: float, ef: int, method: str,
                  max_K: int | None) -> None:
        if method not in _METHOD_STATUS:
            raise ValueError(f"unknown progressive method {method!r}")
        if k > self.max_k:
            raise ValueError(f"k={k} exceeds engine max_k={self.max_k}")
        self.ks[lane] = k
        self.epss[lane] = eps
        self.efs[lane] = ef
        self.K[lane] = k
        self.iters[lane] = 0
        self.maxK[lane] = max_K or self.graph.size
        self.out_ids[lane] = -1
        self.out_sc[lane] = 0.0
        self.to_pss[lane] = method == "pss"
        self.status[lane] = _METHOD_STATUS[method]

    def admit(self, lane: int, q, *, k: int | None = None,
              eps: float | None = None, ef: int | None = None,
              method: str = "pss", max_K: int | None = None) -> None:
        """Recycle lane ``lane`` for a new request. ``q`` is a query vector
        with explicit ``k``/``eps`` keywords, or a ``LaneRequest`` carrying
        all of them (then no keywords may be given)."""
        if isinstance(q, LaneRequest):
            if (k, eps, ef, max_K) != (None,) * 4 or method != "pss":
                raise TypeError("pass parameters on the LaneRequest, not as "
                                "admit keywords")
            req = q
            q, k, eps = req.q, req.k, req.eps
            ef, method, max_K = req.ef, req.method, req.max_K
        elif k is None or eps is None:
            raise TypeError("admit needs k= and eps= (or a LaneRequest)")
        if self.status[lane] not in (LANE_FREE, LANE_DONE):
            raise RuntimeError(f"lane {lane} is still occupied")
        if lane in self._unharvested:     # direct re-admission skips harvest
            self._unharvested.remove(lane)
        ef = int(ef or self.default_ef)
        n = self.graph.size
        cap0 = self._capacity0 or min(_next_pow2(max(2 * k * ef, 256)),
                                      _next_pow2(n))
        self.driver.recycle(lane, q, cap0)
        self._set_lane(lane, k, eps, ef, method, max_K)

    def admit_in_place(self, lane: int, *, k: int, eps: float, ef: int,
                       method: str = "pss", max_K: int | None = None) -> None:
        """Admit a lane whose state the driver already initialized."""
        self._set_lane(lane, k, eps, ef, method, max_K)

    def harvest(self) -> list[tuple[int, DiverseResult]]:
        """Drain the lanes that finished since the last harvest."""
        out = [(lane, self.result(lane)) for lane in self._unharvested]
        self._unharvested = []
        return out

    def recycle(self, lane: int) -> None:
        """Return a harvested lane's slot to the free pool."""
        if self.status[lane] != LANE_DONE:
            raise RuntimeError(f"lane {lane} is not finished")
        self.status[lane] = LANE_FREE

    # -- results ------------------------------------------------------------
    def result(self, lane: int) -> DiverseResult:
        """Solo-driver-compatible result for a finished lane."""
        k = int(self.ks[lane])
        ids = self.out_ids[lane, :k].copy()
        sc = self.out_sc[lane, :k].copy()
        return DiverseResult(ids.astype(np.int32), sc.astype(np.float32),
                             float(sc.sum()), self.driver.stats.lane_view(lane))

    def gather(self, k: int) -> BatchDiverseResult:
        """All-lane result at a uniform ``k`` (lockstep wrappers)."""
        ids = self.out_ids[:, :k].copy()
        sc = self.out_sc[:, :k].copy()
        return BatchDiverseResult(ids, sc, sc.sum(axis=1), self.driver.stats)

    # -- the state machine --------------------------------------------------
    def step(self) -> list[int]:
        """Advance every occupied lane one progressive round.

        1. search burst — PGS/PDS lanes stabilize their first K*ef.
        2. PGS round    — one fused diversify call per group; grow K /
           warm-start PSS / finish.
        3. PDS round    — Theorem-1 degree schedule; update K / go final.
        4. PDS final    — one certified div-A*.
        5. PSS round    — div-A* + Theorem-2 certificate; uncertified lanes
           resume ProgressiveBeamSearch* below their minValue.

        Returns the lane indices that finished during this step.
        """
        finished: list[int] = []
        smask = (self.status == LANE_PGS) | (self.status == LANE_PDS)
        stable = np.zeros(self.B, np.int64)
        if smask.any():
            targets = np.where(smask, self.K * self.efs, 0)
            stable = self.driver.ensure_stable(targets, active=smask)
        gmask = self.status == LANE_PGS
        if gmask.any():
            self._pgs_round(gmask, stable, finished)
        pmask = self.status == LANE_PDS
        if pmask.any():
            self._pds_round(pmask, stable)
        fmask = self.status == LANE_PDS_FIN
        if fmask.any():
            self._pds_final(fmask, finished)
        vmask = self.status == LANE_PSS
        if vmask.any():
            self._pss_round(vmask, finished)
        return finished

    def run_to_completion(self) -> None:
        while self.active_count():
            self.step()

    def _group_eps(self, idx: np.ndarray) -> torch.Tensor:
        return self.driver._t(self.epss[idx].astype(np.float32), torch.float32)

    def _finish(self, lane: int, finished: list[int]) -> None:
        self.driver.stats.K_final[lane] = self.K[lane]
        self.status[lane] = LANE_DONE
        self._unharvested.append(int(lane))
        finished.append(int(lane))

    # Alg. 2 round: one fused diversification call over the stabilized prefix.
    def _pgs_round(self, gmask, stable, finished) -> None:
        d, n = self.driver, self.graph.size
        exhausted = gmask & (stable < np.minimum(self.K * self.efs, n))
        self.K = np.where(exhausted, np.maximum(self.K, stable), self.K)
        count = np.zeros(self.B, np.int64)
        for idx, ids, scores, Ks_g in d.prefix_groups_raw(self.K, gmask,
                                                          ks=self.ks):
            k_g = int(self.ks[idx[0]])
            width = ids.shape[1]
            d.signatures.note("fused_round", _next_pow2(len(idx)), width, k_g)
            sel_ids, sel_sc, cnt, _cert = kops.fused_round_batch(
                self.graph.vectors, ids, scores, Ks_g, self._group_eps(idx),
                k_g, self.graph.metric, impl=self.kernel_impl)
            count[idx] = cnt.cpu().numpy()
            self.out_ids[idx, :k_g] = sel_ids.cpu().numpy()
            self.out_sc[idx, :k_g] = sel_sc.cpu().numpy()
        d.stats.div_calls[gmask] += 1
        success = gmask & (count >= self.ks)
        ex_term = gmask & ~success & exhausted
        d.stats.exhausted |= ex_term
        cont = gmask & ~success & ~ex_term
        self.K = np.where(cont, self.K + self.ks, self.K)
        self.iters[cont] += 1
        iter_term = cont & (self.iters >= self.max_iters)
        for lane in np.flatnonzero(success | ex_term | iter_term):
            if self.to_pss[lane]:
                d.stats.K_final[lane] = self.K[lane]
                self.status[lane] = LANE_PSS
                self.iters[lane] = 0
            else:
                self._finish(lane, finished)

    # Alg. 3 round: Theorem-1 degree schedule for the next K.
    def _pds_round(self, pmask, stable) -> None:
        d, n = self.driver, self.graph.size
        K_new = np.zeros(self.B, np.int64)
        for idx, ids, scores in d.prefix_groups(self.K, pmask, ks=self.ks):
            k_g = int(self.ks[idx[0]])
            g, width = _next_pow2(len(idx)), ids.shape[1]
            d.signatures.note("adjacency", g, width)
            adj = _batched_adjacency(self.graph.vectors, ids,
                                     self._group_eps(idx), self.graph.metric,
                                     self.kernel_impl)
            d.signatures.note("theorem1", g, width, k_g)
            K_new[idx] = _batched_theorem1(adj, ids >= 0, k_g).cpu().numpy()
        K_new = np.minimum(K_new, n)
        ex = pmask & (K_new > self.maxK)
        d.stats.exhausted |= ex
        fin_stable = pmask & ~ex & (stable >= np.minimum(K_new * self.efs, n))
        cont = pmask & ~ex & ~fin_stable
        self.K = np.where(fin_stable | cont, K_new, self.K)
        self.iters[cont] += 1
        iter_term = cont & (self.iters >= self.max_iters)
        self.status[ex | fin_stable | iter_term] = LANE_PDS_FIN

    def _verify_group(self, idx, ids, scores):
        """G^eps + div-A* of one prefix group; host arrays per lane."""
        k_g = int(self.ks[idx[0]])
        g, width = _next_pow2(len(idx)), ids.shape[1]
        self.driver.signatures.note("adjacency", g, width)
        adj = _batched_adjacency(self.graph.vectors, ids, self._group_eps(idx),
                                 self.graph.metric, self.kernel_impl)
        self.driver.signatures.note("div_astar", g, width, k_g)
        masked = torch.where(ids >= 0, scores, NEG_INF)
        sets, best, complete, mv = _batched_div_astar(masked, adj, k_g,
                                                      self.max_expansions)
        return (k_g, width, sets, best, complete, mv, ids.cpu().numpy(),
                scores.cpu().numpy())

    def _write_set(self, lane, k_g, s, ids_np, sc_np) -> None:
        self.out_ids[lane, :k_g] = np.where(s >= 0, ids_np[np.maximum(s, 0)], -1)
        self.out_sc[lane, :k_g] = np.where(s >= 0, sc_np[np.maximum(s, 0)], 0.0)

    # Alg. 3 final: one certified div-A* over the scheduled prefix.
    def _pds_final(self, fmask, finished) -> None:
        d = self.driver
        for idx, ids, scores in d.prefix_groups(self.K, fmask, ks=self.ks):
            k_g, _, sets, _, complete, _, ids_np, sc_np = \
                self._verify_group(idx, ids, scores)
            for gi, lane in enumerate(idx):
                self._write_set(lane, k_g, sets[gi, k_g - 1], ids_np[gi],
                                sc_np[gi])
                d.stats.certified[lane] = (bool(complete[gi])
                                           and not bool(d.stats.exhausted[lane]))
        d.stats.div_calls[fmask] += 1
        for lane in np.flatnonzero(fmask):
            self._finish(lane, finished)

    # Alg. 4 round: div-A* + Theorem-2 certificate, then resumption.
    def _pss_round(self, vmask, finished) -> None:
        d, n = self.driver, self.graph.size
        over = vmask & (self.iters >= self.max_iters)
        for lane in np.flatnonzero(over):
            self._finish(lane, finished)
        mask = vmask & ~over
        if not mask.any():
            return
        self.iters[mask] += 1
        self.K = np.where(mask, np.maximum(self.ks, np.minimum(self.K, n)),
                          self.K)
        min_values = np.full(self.B, -np.inf)
        s_K = np.full(self.B, -np.inf)
        complete = np.zeros(self.B, bool)
        for idx, ids, scores in d.prefix_groups(self.K, mask, ks=self.ks):
            k_g, width, sets, best, comp, mv, ids_np, sc_np = \
                self._verify_group(idx, ids, scores)
            for gi, lane in enumerate(idx):
                complete[lane] = comp[gi]
                min_values[lane] = mv[gi]
                if np.isfinite(best[gi, k_g - 1]):
                    self._write_set(lane, k_g, sets[gi, k_g - 1], ids_np[gi],
                                    sc_np[gi])
                s_K[lane] = (sc_np[gi, self.K[lane] - 1]
                             if self.K[lane] <= width else -np.inf)
        d.stats.div_calls[mask] += 1
        certified = mask & (min_values > s_K)
        d.stats.certified |= certified & complete
        stop = mask & ~certified & (d.stats.exhausted | (self.K >= n))
        for lane in np.flatnonzero(certified | stop):
            self._finish(lane, finished)
        rem = mask & ~certified & ~stop
        if not rem.any():
            return
        stable_before = d.stable_prefix_len()
        stable = d.expand_until_below(np.asarray(min_values, np.float32), rem)
        no_prog = rem & (stable <= stable_before)
        d.stats.exhausted |= no_prog
        hard = no_prog & ((stable >= n) | (d.caps >= d.max_capacity))
        self.K = np.where(rem & hard, np.minimum(stable, n), self.K)
        self.K = np.where(rem & ~hard,
                          np.maximum(self.ks, stable // self.efs), self.K)

    # -- prewarm ------------------------------------------------------------
    def prewarm(self, *, max_capacity: int | None = None,
                ks: tuple = (), widths: tuple = ()) -> list[tuple]:
        """Run every stage once per shape class ahead of serving.

        Walks the power-of-two physical capacities from the current one up
        to ``max_capacity`` (default: the driver's max) and runs the burst
        (with a zero step budget), a lane recycle and every power-of-two
        group size's growth rebuild at each rung, on throwaway states; then,
        for the ``ks`` x ``widths`` grid, the prefix mask, adjacency, greedy
        selection, fused round, Theorem 1 and div-A*. The first use of each
        kernel builds it, so serving never pays a build. The live lane state
        is untouched. Returns the signatures warmed.
        """
        d = self.driver
        impl = self.kernel_impl
        dev = self.graph.device
        top = min(max_capacity or d.max_capacity, d.max_capacity)
        qs0 = torch.zeros((self.B, self.graph.dim), device=dev)
        caps_ladder = []
        c = d.physical_capacity
        while True:
            caps_ladder.append(c)
            if c >= top:
                break
            c *= 2
        group_sizes = pow2_group_sizes(self.B)
        warmed: list[tuple] = []

        def note(kind, *shape):
            d.signatures.note(kind, *shape)
            warmed.append((kind, *shape))

        zeros_b = torch.zeros(self.B, dtype=torch.int32, device=dev)
        for cap in caps_ladder:
            state = lane_state.init_lanes(self.graph, qs0, cap, impl=impl)
            note("init", self.B, cap)
            _batched_search_loop(
                self.graph.vectors, self.graph.neighbors, qs0, state,
                torch.full((self.B,), cap, dtype=torch.int32, device=dev),
                zeros_b, torch.zeros(self.B, device=dev), zeros_b,
                self.graph.metric, impl)
            note("search", self.B, cap)
            lane_state.recycle_lane(self.graph, state, 0,
                                    np.zeros(self.graph.dim, np.float32),
                                    impl=impl)
            note("recycle", self.B, cap)
            for g in group_sizes:
                sub = lane_state.select_lanes(state, np.zeros(g, np.int64))
                sub = lane_state.slice_queue_capacity(sub, cap)
                _rebuild_lanes(self.graph, qs0[:g], sub, cap, impl)
                note("rebuild", g, cap)
        for k in ks:
            for width in widths:
                for g in group_sizes:
                    ids = torch.full((g, width), -1, dtype=torch.int32,
                                     device=dev)
                    sc = torch.full((g, width), NEG_INF, device=dev)
                    eps = torch.zeros(g, device=dev)
                    note("prefix", g, width)
                    _mask_prefix(ids, sc, torch.zeros(g, dtype=torch.int32,
                                                      device=dev))
                    note("adjacency", g, width)
                    adj = _batched_adjacency(self.graph.vectors, ids, eps,
                                             self.graph.metric, impl)
                    note("greedy", g, width, k)
                    kops.greedy_diversify_batch(sc, adj, k, valid=ids >= 0,
                                                impl=impl)
                    note("fused_round", g, width, k)
                    kops.fused_round_batch(self.graph.vectors, ids, sc,
                                           np.zeros(g, np.int64), eps, k,
                                           self.graph.metric, impl=impl)
                    note("theorem1", g, width, k)
                    _batched_theorem1(adj, ids >= 0, k)
                    note("div_astar", g, width, k)
                    _batched_div_astar(sc, adj, k, self.max_expansions)
        return warmed


# ------------------------------------------------------- lockstep wrappers --

def _run_lockstep(graph: FlatGraph, qs, k: int, eps: float, ef: int,
                  method: str, max_iters: int, max_expansions: int,
                  driver: BatchProgressiveDriver | None = None,
                  max_K: int | None = None,
                  kernel_impl: str | None = None
                  ) -> tuple[BatchDiverseResult, ProgressiveEngine]:
    if driver is None:
        driver = BatchProgressiveDriver(graph, qs, ef, k,
                                        kernel_impl=kernel_impl)
    engine = ProgressiveEngine(graph, driver=driver, max_k=k, default_ef=ef,
                               max_iters=max_iters,
                               max_expansions=max_expansions,
                               kernel_impl=kernel_impl)
    for lane in range(driver.B):
        engine.admit_in_place(lane, k=k, eps=eps, ef=ef, method=method,
                              max_K=max_K)
    engine.run_to_completion()
    return engine.gather(k), engine


def batch_pgs(graph: FlatGraph, qs, k: int, eps: float, ef: int = 40,
              driver: BatchProgressiveDriver | None = None,
              max_iters: int = 64, kernel_impl: str | None = None
              ) -> tuple[BatchDiverseResult, BatchProgressiveDriver, np.ndarray]:
    """Batched Alg. 2: returns (result, driver, K_final)."""
    res, engine = _run_lockstep(graph, qs, k, eps, ef, "pgs", max_iters,
                                400_000, driver=driver,
                                kernel_impl=kernel_impl)
    return res, engine.driver, engine.K.copy()


def batch_pds(graph: FlatGraph, qs, k: int, eps: float, ef: int = 40,
              max_K: int | None = None, max_iters: int = 64,
              max_expansions: int = 400_000,
              kernel_impl: str | None = None) -> BatchDiverseResult:
    """Batched Alg. 3 (Theorem-1 degree schedule)."""
    res, _ = _run_lockstep(graph, qs, k, eps, ef, "pds", max_iters,
                           max_expansions, max_K=max_K,
                           kernel_impl=kernel_impl)
    return res


def _concat_results(parts: list[BatchDiverseResult]) -> BatchDiverseResult:
    stats = BatchSearchStats(*[
        np.concatenate([getattr(p.stats, f.name) for p in parts])
        for f in dataclasses.fields(BatchSearchStats)])
    return BatchDiverseResult(np.vstack([p.ids for p in parts]),
                              np.vstack([p.scores for p in parts]),
                              np.concatenate([p.totals for p in parts]),
                              stats)


def batch_pss(graph: FlatGraph, qs, k: int, eps: float, ef: int = 40,
              max_iters: int = 64, max_expansions: int = 400_000,
              streams: int = 1,
              kernel_impl: str | None = None) -> BatchDiverseResult:
    """Batched Alg. 4 — the lockstep engine entry point.

    Phase 1 runs batched PGS (warm start). Each round then builds every
    active lane's G^eps, runs div-A*, applies the Theorem-2 certificate per
    lane, and resumes ProgressiveBeamSearch* only for the uncertified lanes.
    ``qs`` is a float array or tensor (B, d); the engine runs on the graph's
    device. ``streams > 1`` splits the batch into that many sub-batches
    driven from worker threads; every lane's trajectory is independent of
    its batch, so results do not change.
    """
    qs = np.asarray(qs.cpu() if isinstance(qs, torch.Tensor) else qs,
                    np.float32)
    if streams > 1 and qs.shape[0] > 1:
        parts = np.array_split(np.arange(qs.shape[0]),
                               min(streams, qs.shape[0]))
        with concurrent.futures.ThreadPoolExecutor(len(parts)) as ex:
            futs = [ex.submit(batch_pss, graph, qs[c], k, eps, ef, max_iters,
                              max_expansions, 1, kernel_impl) for c in parts]
            return _concat_results([f.result() for f in futs])
    res, _ = _run_lockstep(graph, qs, k, eps, ef, "pss", max_iters,
                           max_expansions, kernel_impl=kernel_impl)
    return res


def batch_progressive_search(graph: FlatGraph, qs, k: int, eps: float,
                             method: str = "pss", ef: int = 40,
                             **kwargs) -> BatchDiverseResult:
    """One entry point for the batched progressive engine."""
    if method == "pss":
        return batch_pss(graph, qs, k, eps, ef, **kwargs)
    if method == "pds":
        return batch_pds(graph, qs, k, eps, ef, **kwargs)
    if method == "pgs":
        res, _, _ = batch_pgs(graph, qs, k, eps, ef, **kwargs)
        return res
    raise ValueError(f"unknown batched progressive method {method!r}")
