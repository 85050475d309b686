"""ShardedEngine: per-lane progressive budgets over a sharded index (port of
``repro.sharded_search.engine``).

A lane is one query of the batch that rides over every shard. Each round
(``step()``) buckets the occupied lanes by their ``(K-budget, k)`` and
dispatches each bucket at its budget: shard-local beams, the merge, then
the replicated div-A* of ``sharded_diverse_search``; ``eps`` rides per
lane. Nothing is compiled, so a bucket goes as it is; the signature log
records the power-of-two group the reference compiles for it. A
lane whose Theorem-2 certificate fires, or whose budget reached the corpus
or its ``max_K``, finishes and frees its lane for the next request between
rounds; the others double their budget; a lane out of rounds retires
uncertified at its current budget.

Resumption (``resume=``), as in the reference:

* ``"beam"`` (default): a ``ShardedSearchState`` (each lane's per-shard
  queue and visited set, its capacity sized once) carries across rounds,
  so a doubled budget continues each shard's beam from the last frontier.
  A lane finished in its first round equals ``sharded_diverse_search`` at
  its final budget; a multi-round lane reuses its expansions and carries
  the certificate-soundness contract instead.
* ``"scratch"``: every round reruns the beams cold; every lane equals
  ``sharded_diverse_search`` at its final budget.

``result()`` reports each lane's real counters: cumulative shard-local
expansions (a scratch round re-counts the work it redoes), budget doublings
and rounds. The elastic half of the reference engine (``swap_index``,
``prepare_rescale``, ``rescale_options``, ``rescale``) comes with a later
slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.backend import LaneRequest
from repro_torch.core.batch_progressive import SignatureLog
from repro_torch.core.bucketing import next_pow2, pow2_group_sizes
from repro_torch.core.pgs import DiverseResult
from repro_torch.core.progressive import SearchStats
from repro_torch.sharded_search.search import (ShardedIndex,
                                               beam_state_capacity,
                                               init_sharded_state,
                                               sharded_diverse_resume,
                                               sharded_diverse_search)

LANE_FREE, LANE_RUN, LANE_DONE = range(3)


class ShardedEngine:
    """Per-lane progressive budgets over a sharded index.

    Drive it with ``admit`` / ``step`` / ``harvest`` / ``recycle`` (as
    ``sharded_progressive_diverse`` does). ``record_candidates`` keeps each
    lane's last merged candidate frontier on the host
    (``last_candidates``) so certificates can be re-checked independently.
    The float corpus ``all_vectors`` is kept on the index's device; for a
    quantized index it stays on the host, read only by the exact rerank.
    """

    methods = ("sharded",)

    def __init__(self, index: ShardedIndex, all_vectors, mesh,
                 num_lanes: int = 8, *, axis: str = "data",
                 K0: int = 32, L_factor: int = 4, merge: str = "tournament",
                 max_expansions: int = 100_000, max_rounds: int = 8,
                 max_k: int = 16, resume: str = "beam",
                 state_capacity: int | None = None,
                 record_candidates: bool = False):
        if resume not in ("beam", "scratch"):
            raise ValueError(f"unknown resume mode {resume!r}")
        self.index = index
        self.compressed = index.scheme is not None
        xs = torch.as_tensor(all_vectors)
        self.all_vectors = (xs.cpu().numpy().astype(np.float32, copy=False)
                            if self.compressed else
                            xs.to(index.device, torch.float32).contiguous())
        self.mesh = mesh
        self.axis = axis
        self.K0 = K0
        self.L_factor = L_factor
        self.merge = merge
        self.max_expansions = max_expansions
        self.max_rounds = max_rounds
        self.max_k = max_k
        self.resume = resume
        self.record_candidates = record_candidates
        self.B = int(num_lanes)
        self.n_total = index.num_shards * index.shard_size
        d = int(index.dim)
        self.qs = np.zeros((self.B, d), np.float32)
        self.status = np.full(self.B, LANE_FREE, np.int8)
        self.ks = np.ones(self.B, np.int64)
        self.epss = np.zeros(self.B, np.float64)
        self.K = np.zeros(self.B, np.int64)
        self.maxK = np.full(self.B, self.n_total, np.int64)
        self.rounds = np.zeros(self.B, np.int64)
        self.out_ids = np.full((self.B, max_k), -1, np.int32)
        self.out_sc = np.zeros((self.B, max_k), np.float32)
        self.cert = np.zeros(self.B, bool)
        self.expansions = np.zeros(self.B, np.int64)
        self.fresh = np.ones(self.B, bool)
        #: per-lane (cand_ids, cand_scores) of the last dispatched round,
        #: kept when ``record_candidates``
        self.last_candidates: list = [None] * self.B
        if resume == "beam":
            floor = beam_state_capacity(index, self.n_total, L_factor)
            cap = state_capacity or floor
            if cap < floor:
                # a narrower queue drops beam candidates: harvest pads with
                # -inf rows, which passes the certificate's min_value > s_K
                # trivially and voids both contracts — refuse here
                raise ValueError(
                    f"state_capacity={cap} is below the resumable-beam "
                    f"floor {floor} (beam_state_capacity); the widening "
                    "contract needs the queue to hold every rung's beam "
                    "or the whole shard")
            self.beam_state = init_sharded_state(index, self.B, cap, mesh,
                                                 axis)
        else:
            self.beam_state = None
        self.signatures = SignatureLog()
        self._unharvested: list[int] = []

    # -- protocol surface ---------------------------------------------------
    @property
    def num_lanes(self) -> int:
        return self.B

    @property
    def num_shards(self) -> int:
        return self.index.num_shards

    @property
    def bytes_per_vector(self) -> float:
        """Stored corpus bytes per vector of one shard."""
        return float(self.index.corpus_bytes_per_vector())

    @property
    def signature_log(self) -> SignatureLog:
        return self.signatures

    def free_lanes(self) -> np.ndarray:
        return np.flatnonzero(self.status == LANE_FREE)

    def active_count(self) -> int:
        return int((self.status == LANE_RUN).sum())

    def admit(self, lane: int, request: LaneRequest) -> None:
        """Hand a free lane to ``request``: a fresh budget ladder from
        ``K0``; the other lanes keep their budgets and beams."""
        if self.status[lane] != LANE_FREE:
            raise RuntimeError(f"mesh lane {lane} is still occupied")
        k = int(request.k)
        if k > self.max_k:
            raise ValueError(f"k={k} exceeds engine max_k={self.max_k}")
        if request.method not in self.methods:
            raise ValueError(f"unknown sharded method {request.method!r}")
        self.qs[lane] = np.asarray(request.q, np.float32)
        self.ks[lane] = k
        self.epss[lane] = float(request.eps)
        self.maxK[lane] = min(request.max_K or self.n_total, self.n_total)
        self.K[lane] = min(max(self.K0, 2 * k), self.maxK[lane])
        self.rounds[lane] = 0
        self.out_ids[lane] = -1
        self.out_sc[lane] = 0.0
        self.cert[lane] = False
        self.expansions[lane] = 0
        self.fresh[lane] = True   # the first dispatch re-seeds its beams
        self.last_candidates[lane] = None
        self.status[lane] = LANE_RUN

    def recycle(self, lane: int) -> None:
        """Return a harvested lane to the free pool (its beams are re-seeded
        on the next admit)."""
        if self.status[lane] != LANE_DONE:
            raise RuntimeError(f"mesh lane {lane} is not finished")
        self.fresh[lane] = True
        self.status[lane] = LANE_FREE

    # -- the round ----------------------------------------------------------
    def _dispatch(self, idx: np.ndarray, Kval: int, k_g: int) -> None:
        self.signatures.note("sharded", next_pow2(len(idx)), Kval, k_g)
        epss = self.epss[idx].astype(np.float32)
        if self.resume == "beam":
            ids, scores, cand_ids, cand_sc, cert, self.beam_state = \
                sharded_diverse_resume(
                    self.index, self.all_vectors, self.beam_state,
                    self.qs[idx], idx, self.fresh[idx], k_g, epss,
                    Kval, self.mesh, self.axis, self.L_factor, self.merge,
                    "div_astar", self.max_expansions)
            self.fresh[idx] = False
            # cumulative expansions since each lane's seed: its carried
            # step counters summed over the shards
            steps = self.beam_state.steps.sum(dim=0).cpu().numpy()
            self.expansions[idx] = steps[idx]
        else:
            ids, scores, cert, exp = sharded_diverse_search(
                self.index, self.all_vectors, self.qs[idx], k_g, epss,
                Kval, self.mesh, self.axis, self.L_factor, self.merge,
                "div_astar", self.max_expansions, with_expansions=True)
            cand_ids = cand_sc = None
            # every scratch round redoes (and re-counts) its prior work
            self.expansions[idx] += exp.cpu().numpy()
        self.out_ids[idx, :k_g] = ids.cpu().numpy()
        self.out_sc[idx, :k_g] = scores.cpu().numpy()
        self.cert[idx] = cert.cpu().numpy()
        if self.record_candidates and cand_ids is not None:
            cids, csc = cand_ids.cpu().numpy(), cand_sc.cpu().numpy()
            for row, lane in enumerate(idx):
                self.last_candidates[int(lane)] = (cids[row].copy(),
                                                   csc[row].copy())

    def step(self) -> list[int]:
        """Advance every occupied lane one budget round; returns the lanes
        that finished (also queued for ``harvest``)."""
        active = self.status == LANE_RUN
        if not active.any():
            return []
        buckets: dict[tuple, list[int]] = {}
        for i in np.flatnonzero(active):
            buckets.setdefault((int(self.K[i]), int(self.ks[i])), []).append(i)
        for (Kval, k_g), idx in sorted(buckets.items()):
            self._dispatch(np.asarray(idx), Kval, k_g)
        self.rounds[active] += 1
        finished = active & (self.cert | (self.K >= self.maxK))
        still = active & ~finished
        # a lane out of rounds retires uncertified at its current budget,
        # so K_final is always a budget that was dispatched
        retired = still & (self.rounds >= self.max_rounds)
        cont = still & ~retired
        self.K[cont] = np.minimum(self.K[cont] * 2, self.maxK[cont])
        done = np.flatnonzero(finished | retired)
        for lane in done:
            self.status[lane] = LANE_DONE
            self._unharvested.append(int(lane))
        return [int(x) for x in done]

    def harvest(self) -> list[tuple[int, DiverseResult]]:
        """Drain the lanes finished since the last harvest; each stays
        reserved until ``recycle``."""
        out = [(lane, self.result(lane)) for lane in self._unharvested]
        self._unharvested = []
        return out

    def result(self, lane: int) -> DiverseResult:
        """The lane's result with its real counters; under
        ``resume="scratch"`` (or for a single-round lane under ``"beam"``)
        (ids, scores, certified) equal ``sharded_diverse_search`` for its
        query at ``stats.K_final``."""
        k = int(self.ks[lane])
        ids = self.out_ids[lane, :k].copy()
        sc = self.out_sc[lane, :k].copy()
        certified = bool(self.cert[lane])
        stats = SearchStats(
            expansions=int(self.expansions[lane]),
            growths=max(0, int(self.rounds[lane]) - 1),
            search_calls=int(self.rounds[lane]),
            div_calls=int(self.rounds[lane]),
            certified=certified,
            exhausted=bool(not certified
                           and int(self.K[lane]) >= int(self.maxK[lane])),
            K_final=int(self.K[lane]))
        return DiverseResult(ids.astype(np.int32), sc.astype(np.float32),
                             float(sc.sum()), stats)

    # -- prewarm ------------------------------------------------------------
    def prewarm(self, *, max_capacity: int | None = None,
                ks: tuple = ()) -> list[tuple]:
        """Run the dispatch ladder once ahead of serving: the power-of-two
        group sizes up to ``num_lanes`` crossed with the budgets from
        ``K0`` up to ``max_capacity`` (default ``K0`` alone) for each ``k``
        in ``ks`` (default ``max_k``), a group of g on lanes 0..g-1.
        Nothing is compiled here; the pass builds the kernels on first use
        and records the signatures."""
        if (self.status != LANE_FREE).any():
            raise RuntimeError("prewarm before admitting requests (prewarm "
                               "dispatches scribble on the lanes' result rows)")
        top = min(max_capacity or self.K0, self.n_total)
        ks = tuple(int(k) for k in ks) or (self.max_k,)
        warmed: list[tuple] = []
        for g in pow2_group_sizes(self.B):
            lanes = np.arange(min(g, self.B))
            for k in ks:
                K = min(max(self.K0, 2 * k), self.n_total)
                self.fresh[lanes] = True   # each ladder seeds its lanes afresh
                while True:
                    self._dispatch(lanes, K, k)
                    warmed.append(("sharded", g, K, k))
                    if K >= top:
                        break
                    K = min(K * 2, self.n_total)
        # prewarm dispatches scribble on the (free) lanes' rows; wipe them
        self.out_ids[:] = -1
        self.out_sc[:] = 0.0
        self.cert[:] = False
        self.expansions[:] = 0
        self.fresh[:] = True
        self.last_candidates = [None] * self.B
        return warmed
