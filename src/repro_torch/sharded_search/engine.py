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
and rounds.

The index can change under the engine two ways. ``swap_index`` installs a
new epoch's corpus (the mutable index's rebuild) on an idle engine.
``prepare_rescale`` reshards the corpus onto another shard count ahead of
load and runs the target's dispatch ladder once; ``rescale`` then moves the
corpus and every in-flight lane to it between rounds (contract 16): each
lane's queues are re-bucketed by global id on the device, so it resumes its
ladder without redoing expansions, and the lane count may follow the mesh.

Over a process group (``compat.ProcessGroupMesh``, one shard per rank)
every rank runs this host state machine on the same admissions (SPMD): the
buckets, budgets and certificates depend on the admissions and on the
replicated merged candidates only, so every rank dispatches the same
rounds and reaches the same results. ``serve.scheduler`` keeps the ranks'
admissions equal (rank 0 decides, the others follow). The mesh may be the
group's first ranks only (``ProcessGroupMesh.sub``): a rank outside it
holds an index with no local shard and runs no round. Rescaling moves
between such meshes: every rank of the group calls ``prepare_rescale``
(its part of the target built from the host rows it keeps) and
``rescale`` (the old mesh's state gathered over the group, its part of
the target kept). At a grow, ranks that were outside take rank 0's host
lane state, broadcast inside the event.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.backend import LaneRequest
from repro_torch.core.batch_progressive import SignatureLog
from repro_torch.core.bucketing import next_pow2, pow2_group_sizes
from repro_torch.core.pgs import DiverseResult
from repro_torch.core.progressive import SearchStats
from repro_torch.sharded_search.search import (ShardedIndex, _empty_state,
                                               beam_state_capacity,
                                               index_from_host,
                                               index_to_host,
                                               init_sharded_state,
                                               local_shard,
                                               migrate_sharded_state,
                                               rank_shard, reshard_index,
                                               sharded_diverse_resume,
                                               sharded_diverse_search)

LANE_FREE, LANE_RUN, LANE_DONE = range(3)


def adopt_index(index: ShardedIndex, mesh) -> ShardedIndex:
    """``index`` as ``mesh`` serves it: a whole index given over a process
    group becomes this rank's part (its shard, or none outside the mesh);
    anything else as it is."""
    shard = rank_shard(mesh)
    if shard is None or index.total_shards:
        return index
    return index_from_host(local_shard(index_to_host(index), shard),
                           device=index.device)


class ShardedEngine:
    """Per-lane progressive budgets over a sharded index.

    Implements ``core.backend.RescalableBackend``: drive it with ``admit``
    / ``step`` / ``harvest`` / ``recycle`` (as
    ``sharded_progressive_diverse`` does) or through
    ``serve.scheduler.LaneScheduler``. ``record_candidates`` keeps each
    lane's last merged candidate frontier on the host
    (``last_candidates``) so certificates can be re-checked independently.
    The float corpus ``all_vectors`` is kept on the index's device; for a
    quantized index it stays on the host, read only by the exact rerank.
    Over a process group ``index`` is this rank's part (a whole index is
    cut to it, ``adopt_index``) and ``all_vectors`` the whole corpus.
    """

    methods = ("sharded",)

    def __init__(self, index: ShardedIndex, all_vectors, mesh,
                 num_lanes: int = 8, *, axis: str = "data",
                 K0: int = 32, L_factor: int = 4, merge: str = "tournament",
                 max_expansions: int = 100_000, max_rounds: int = 8,
                 max_k: int = 16, default_ef: int = 0, resume: str = "beam",
                 state_capacity: int | None = None,
                 record_candidates: bool = False):
        if resume not in ("beam", "scratch"):
            raise ValueError(f"unknown resume mode {resume!r}")
        index = adopt_index(index, mesh)
        self._set_corpus(index, all_vectors)
        self.mesh = mesh
        self.axis = axis
        self.K0 = K0
        self.L_factor = L_factor
        self.merge = merge
        self.max_expansions = max_expansions
        self.max_rounds = max_rounds
        self.max_k = max_k
        # the mesh backend has no beam-ef knob (beam width = K * L_factor);
        # kept so the scheduler's ef plumbing is backend-neutral
        self.default_ef = default_ef
        self.resume = resume
        self.record_candidates = record_candidates
        self._state_capacity = state_capacity
        self.B = int(num_lanes)
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
        self.beam_state = (init_sharded_state(
            index, self.B, self._target_capacity(index), mesh, axis)
            if resume == "beam" else None)
        self.signatures = SignatureLog()
        self._unharvested: list[int] = []
        #: prepared elastic targets: shard count -> (mesh, index, lanes),
        #: resharded and run once ahead of the scale event
        self._rescale_targets: dict[int, tuple] = {}
        #: bytes the last scale event gathered across ranks
        self.rescale_gathered_bytes = 0

    def _set_corpus(self, index: ShardedIndex, all_vectors) -> None:
        self.index = index
        self.compressed = index.scheme is not None
        xs = torch.as_tensor(all_vectors)
        self.all_vectors = (xs.cpu().numpy().astype(np.float32, copy=False)
                            if self.compressed else
                            xs.to(index.device, torch.float32).contiguous())
        self.n_total = index.num_shards * index.shard_size

    def _target_capacity(self, index: ShardedIndex) -> int:
        """The resumable queue's width over ``index``: ``state_capacity``,
        or the floor ``beam_state_capacity`` when unset."""
        floor = beam_state_capacity(index, self.n_total, self.L_factor)
        cap = self._state_capacity or floor
        if cap < floor:
            # a narrower queue drops beam candidates: harvest pads with
            # -inf rows, which passes the certificate's min_value > s_K
            # trivially and voids both contracts. Shrinking the mesh grows
            # the shards and can raise the floor past a pinned capacity:
            # refused when the target is prepared, not mid-migration
            raise ValueError(
                f"state_capacity={cap} is below the resumable-beam floor "
                f"{floor} of {index.num_shards} shards (beam_state_capacity); "
                "the widening contract needs the queue to hold every rung's "
                "beam or the whole shard")
        return cap

    # -- protocol surface ---------------------------------------------------
    @property
    def num_lanes(self) -> int:
        return self.B

    @property
    def num_shards(self) -> int:
        return self.index.num_shards

    @property
    def member(self) -> bool:
        """Whether this process holds a shard of the serving mesh (always
        on one process; outside a process group's sub-mesh it runs no
        round)."""
        return self.mesh.local_size > 0

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
            steps = self.mesh.psum(self.beam_state.steps,
                                   self.axis).cpu().numpy()
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

    # -- epoch swap ----------------------------------------------------------
    def swap_index(self, index: ShardedIndex, all_vectors) -> None:
        """Install a new epoch's sharded index (the mutable index's rebuild
        swap). Only legal with no lane running: the carried state is laid
        out per shard of the old corpus, so it starts afresh over the new
        one (the serving layer drains in-flight lanes first, contract 15;
        finished, unrecycled lanes keep their host results). The shard
        count stays (the rebuild pads the corpus to divisibility instead);
        the signature log carries across epochs. Prepared elastic targets
        hold the old epoch's rows, so they are dropped: the caller prepares
        them again over the new epoch."""
        if self.active_count():
            raise RuntimeError("cannot swap the index under occupied lanes "
                               "— drain in-flight lanes first (contract 15)")
        if index.num_shards != self.index.num_shards:
            raise ValueError(
                f"epoch swap cannot change the shard count "
                f"({self.index.num_shards} -> {index.num_shards}); pad the "
                "corpus to divisibility instead")
        self._set_corpus(index, all_vectors)
        self.maxK = np.minimum(self.maxK, self.n_total)
        if self.resume == "beam":
            self.beam_state = init_sharded_state(
                index, self.B, self._target_capacity(index), self.mesh,
                self.axis)
            self.fresh[:] = True
        self._rescale_targets.clear()
        self.signatures.note("swap", self.B, self.n_total)

    # -- elastic rescale -----------------------------------------------------
    def prepare_rescale(self, shards: int, mesh, index: ShardedIndex | None
                        = None, *, M: int | None = None,
                        builder: str = "knng", prewarm: bool = True,
                        max_capacity: int | None = None, ks: tuple = (),
                        num_lanes: int | None = None) -> ShardedIndex:
        """Build (or adopt) and run once an elastic target of ``shards``.

        Resharding (``reshard_index``: rows re-blocked, graphs rebuilt) and
        the first pass over the target's dispatch ladder — its group sizes
        up to its lane count crossed with the budgets from ``K0`` up to
        ``max_capacity``, on a throwaway state at the target's queue width —
        happen here, ahead of load, so the scale event itself is only the
        state migration. The ladder's signatures, and ``("rescale", s)``
        for the target and for the current count (the way back), are noted,
        so preparing every target before ``signature_log.freeze()`` keeps
        scale events off the unplanned list.

        ``num_lanes`` gives the target its own lane count (default the
        current one): serving capacity follows the mesh. A lane shrink
        applies at ``rescale`` only when the tail lanes are free then.
        """
        if shards & (shards - 1) or shards < 1:
            raise ValueError(f"shards={shards} must be a power of two")
        B_t = int(num_lanes or self.B)
        if B_t < 1:
            raise ValueError(f"num_lanes={B_t} must be >= 1")
        if index is None:
            index = reshard_index(self.index, shards, self.all_vectors, M=M,
                                  builder=builder, shard=rank_shard(mesh))
        index = adopt_index(index, mesh)
        if index.num_shards != shards:
            raise ValueError(f"prepared index has {index.num_shards} "
                             f"shards, expected {shards}")
        if index.num_shards * index.shard_size != self.n_total:
            raise ValueError("elastic targets must cover the same corpus "
                             "(resharding is a capacity knob)")
        self.signatures.note("rescale", shards)
        self.signatures.note("rescale", self.index.num_shards)
        if prewarm and shards != self.index.num_shards and mesh.local_size:
            state = (init_sharded_state(index, B_t,
                                        self._target_capacity(index), mesh,
                                        self.axis)
                     if self.resume == "beam" else None)
            self._run_ladder(index, mesh, state, B_t, max_capacity, ks)
        self._rescale_targets[shards] = (mesh, index, B_t)
        return index

    def _run_ladder(self, index, mesh, state, B: int, max_capacity, ks):
        """One dispatch of each (group, K, k) rung on zero queries over a
        throwaway state, a group of g on lanes 0..g-1; the results are
        dropped."""
        d = int(index.dim)
        top = min(max_capacity or self.K0, self.n_total)
        for g in pow2_group_sizes(B):
            lanes = np.arange(min(g, B))
            qs = np.zeros((len(lanes), d), np.float32)
            epss = np.zeros(len(lanes), np.float32)
            for k in tuple(int(kk) for kk in ks) or (self.max_k,):
                K = min(max(self.K0, 2 * k), self.n_total)
                while True:
                    self.signatures.note("sharded", g, K, k)
                    if self.resume == "beam":
                        sharded_diverse_resume(
                            index, self.all_vectors, state, qs, lanes,
                            np.ones(len(lanes), bool), k, epss, K, mesh,
                            self.axis, self.L_factor, self.merge,
                            "div_astar", self.max_expansions)
                    else:
                        sharded_diverse_search(
                            index, self.all_vectors, qs, k, epss, K, mesh,
                            self.axis, self.L_factor, self.merge,
                            "div_astar", self.max_expansions)
                    if K >= top:
                        break
                    K = min(K * 2, self.n_total)

    def rescale_options(self) -> tuple[int, ...]:
        """Shard counts this engine can serve at right now: the current
        one plus every prepared target."""
        return tuple(sorted(set(self._rescale_targets)
                            | {self.index.num_shards}))

    def rescale(self, shards: int) -> bool:
        """Move the corpus and every in-flight lane to the prepared
        ``shards`` target, between rounds, without draining.

        Over a process group every rank of the group calls it: at a grow,
        ranks that were outside the old mesh first take rank 0's host lane
        state (one broadcast), then the state migrates by one gather over
        the group (``rescale_gathered_bytes``); a rank left outside the new
        mesh frees its host lanes.

        The carried state migrates (``migrate_sharded_state``: queues
        re-bucketed by global id, visited rows and per-lane step totals
        kept), so occupied lanes resume their budget ladder on the new
        topology (contract 16). A target prepared with its own lane count
        appends free lanes, or drops the tail lanes when they are all free
        now (an occupied lane is never dropped: the width stays until the
        tail drains). The outgoing configuration becomes a target, so
        scaling back is one ``rescale`` away. Returns False when already at
        ``shards``; raises if the target was never prepared."""
        if shards == self.index.num_shards:
            return False
        target = self._rescale_targets.get(shards)
        if target is None:
            raise RuntimeError(
                f"no prepared target for {shards} shards — call "
                "prepare_rescale first (resharding is the expensive half; "
                "the scale event itself must not pay it)")
        mesh, index, B_new = target
        world = getattr(mesh, "world", None)
        if rank_shard(mesh) is not None and mesh.size > self.mesh.size:
            self._sync_lanes(world)
        self._rescale_targets[self.index.num_shards] = (self.mesh,
                                                        self.index, self.B)
        if B_new < self.B and (self.status[B_new:] != LANE_FREE).any():
            B_new = self.B   # occupied tail: keep width, move shards only
        gathered = world.gathered_bytes if world is not None else 0
        if self.resume == "beam":
            self.beam_state = migrate_sharded_state(
                self.beam_state, shards, self._target_capacity(index),
                mesh=mesh, axis=self.axis, num_lanes=B_new,
                old_mesh=self.mesh)
        if world is not None:
            self.rescale_gathered_bytes = world.gathered_bytes - gathered
        if B_new != self.B:
            self._resize_lanes(B_new)
        self.index = index
        self.mesh = mesh
        if not self.member:
            # outside the new mesh: no lane of its runs here; a grow brings
            # rank 0's lane state back
            self.status[:] = LANE_FREE
            self._unharvested = []
        self.signatures.note("rescale", shards)
        return True

    def _sync_lanes(self, world) -> None:
        """Rank 0's host lane state on every rank of ``world`` (one
        broadcast); a rank that was outside the mesh also re-shapes its
        empty beam state to rank 0's lanes."""
        fields = list(self._lane_fills())
        mine = (dict(B=self.B, unharvested=list(self._unharvested),
                     **{f: getattr(self, f) for f in fields})
                if world.rank == 0 else None)
        got = world.broadcast_object(mine, src=0)
        if world.rank == 0:
            return
        self.B = int(got["B"])
        self._unharvested = list(got["unharvested"])
        for f in fields:
            setattr(self, f, np.array(got[f]))
        self.last_candidates = [None] * self.B
        if self.resume == "beam" and not self.member:
            st = self.beam_state
            self.beam_state = _empty_state(0, st.visited.shape[-1], self.B,
                                           st.capacity, st.ids.device)

    def _lane_fills(self) -> dict:
        """The per-lane host arrays (lane axis first) of the state machine,
        each with the value of a free lane."""
        return dict(qs=0, status=LANE_FREE, ks=1, epss=0, K=0,
                    maxK=self.n_total, rounds=0, out_ids=-1, out_sc=0,
                    cert=False, expansions=0, fresh=True)

    def _resize_lanes(self, B_new: int) -> None:
        """Pad (grow) or cut (shrink) every per-lane host array to
        ``B_new`` lanes, keeping the surviving prefix; the caller drops
        free tail lanes only."""
        B = self.B
        for name, fill in self._lane_fills().items():
            a = getattr(self, name)
            out = np.full((B_new,) + a.shape[1:], fill, a.dtype)
            out[:min(B, B_new)] = a[:B_new]
            setattr(self, name, out)
        self.last_candidates = (self.last_candidates[:B_new]
                                + [None] * (B_new - B))
        self.B = B_new

    # -- prewarm ------------------------------------------------------------
    def prewarm(self, *, max_capacity: int | None = None, ks: tuple = (),
                widths: tuple = ()) -> list[tuple]:
        """Run the dispatch ladder once ahead of serving: the power-of-two
        group sizes up to ``num_lanes`` crossed with the budgets from
        ``K0`` up to ``max_capacity`` (default ``K0`` alone) for each ``k``
        in ``ks`` (default ``max_k``), a group of g on lanes 0..g-1.
        Nothing is compiled here; the pass builds the kernels on first use
        and records the signatures. ``widths`` is accepted for the
        single-host engine's signature and ignored (no prefix-width
        stage)."""
        del widths
        if not self.member:
            return []      # no shard here: the mesh's ranks run the ladder
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
