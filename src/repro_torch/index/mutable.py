"""Online mutable index: delta segment + deletion bitmap + epoch swap (port
of ``repro.index.mutable``).

The paper's framework assumes a static corpus; real serving takes writes
concurrently with reads. This module adds the incremental path as a
*decorator layer* over the offline builder and the engine, so the
progressive search machinery stays untouched:

* **Delta segment** — upserted vectors land in a fixed-capacity tail of the
  (append-only) host corpus buffer. They are not in any graph yet; instead
  every harvested lane's candidate frontier is merged with a flat scan of
  the live delta (one ``kernels.ops.batch_similarity`` launch over the
  delta's rows, moved to the device per call; an int8 corpus also scores
  the delta's int8 codes with ``quantized_similarity_many``, but the
  merged frontier always carries exact float scores: contract 13).
* **Deletion bitmap** — ``delete`` tombstones ids in place. Vectors are
  never moved or reused (ids are positional and append-only), so every id
  means the same vector in every epoch; the bitmap is applied at harvest,
  *before* diversification and the Theorem-2 audit, and the semantic cache
  revalidates against it. Bitmap and delta stay host numpy: a device
  scatter with repeated indices would not be deterministic.
* **Background rebuild and epoch swap** — when the delta fills,
  ``request_rebuild`` builds a fresh structure (the ``builder``'s graph
  single-host, ``sharded_search.build_sharded_index`` with ``shards=``, on
  the index's device) over a snapshot of the rows, optionally on a
  background thread. The swap is installed **between rounds**:
  ``MutableBackend.free_lanes`` stops admitting while a built structure is
  pending, lets in-flight lanes drain, and installs the new epoch on an
  idle engine (``swap_graph`` / ``swap_index``). Per-lane search state is
  shaped by the corpus size, so the drain barrier is what makes the swap
  atomic. A background build calls CUDA from its own thread on the default
  stream, so it serializes with serving; an exception there is kept and
  raised by the next ``swap_ready`` / ``wait_rebuild``, so it reaches the
  serving loop.
* **Elastic rescale** (``shards=``, contract 16) — over a
  ``ShardedEngine`` the backend is a ``RescalableMutableBackend``: a
  rescale moves the epoch's index to the new shard count, and a rebuild
  that was built for the old count is resharded when it swaps in.
* **Over a process group** (``rank=``, one shard per rank) every rank
  keeps the same host buffer, delta and bitmap, because every rank applies
  rank 0's writes in rank 0's order (``serve.scheduler.RankZeroBackend``
  broadcasts them); each rank builds only its own shard of an epoch (none
  when it lies outside the serving mesh), and a swap is rank 0's decision,
  broadcast: a rank that receives it waits for its own rebuild and
  installs it. The harvest's merge and audit run on rank 0 only.

Contract 15 (``docs/ARCHITECTURE.md``): a search straddling an epoch swap
returns results valid against one epoch or the other, never a mix — every
search runs all its rounds against a single epoch's graph, and its
harvest-time merge (bitmap filter + delta merge + Theorem-2 re-audit) reads
one consistent snapshot of the live corpus, against which the certificate
is sound.

Certificate soundness under the merge: the engine's frontier bounds every
*unexplored graph point* by its K-th candidate score (``s_K``; ``-inf``
when the frontier carries padding, i.e. the graph was exhausted). The
merged frontier adds every live delta point and drops tombstones. The
re-audit certifies with ``min_value > max(s_K_merged, s_K_engine)``.

``builder`` is "knng" (``index.flat.build_knn_graph``) or "hnsw"
(``index.hnsw.build_hnsw``, the paper's index, upper levels included
single-host). ``quantized=`` without ``shards=`` raises
``NotImplementedError``: the reference's single-host engine cannot serve a
quantized graph either, so there is nothing to port.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch import quant, resolve_device
from repro_torch.core import theorems
from repro_torch.core.backend import RescalableBackend
from repro_torch.core.graph import FlatGraph, to_device
from repro_torch.core.pgs import DiverseResult
from repro_torch.kernels import ops as kops


class DeltaFull(RuntimeError):
    """The delta segment overflowed its hard limit while a rebuild was
    still pending — writes are arriving faster than rebuilds retire them.
    Back off, or raise ``delta_capacity``."""


def _compact_served(ids, scores, live):
    """Keep the served set's order, drop dead rows, pad with -1 at the end."""
    k = ids.shape[0]
    keep = np.flatnonzero(live)
    out_ids = np.full(k, -1, np.int32)
    out_sc = np.zeros(k, np.float32)
    out_ids[: keep.size] = ids[keep]
    out_sc[: keep.size] = scores[keep]
    return out_ids, out_sc


def refuse_unported(*, shards=None, quantized=None) -> None:
    """Raise ``NotImplementedError`` for ``quantized=`` without ``shards=``:
    the reference's single-host engine cannot serve a quantized graph
    either (its burst indexes the corpus as float rows), so there is
    nothing to port. A compressed corpus is served sharded."""
    if quantized is not None and not shards:
        raise NotImplementedError(
            "quantized= without shards=: the reference's single-host engine "
            "cannot serve a quantized graph either, so there is nothing to "
            "port; pass shards= with quantized=")


class MutableIndex:
    """Append-only host corpus + delta segment + deletion bitmap +
    epoch'd search structure (``FlatGraph``, or ``ShardedIndex`` with
    ``shards=``) on ``device`` (``cuda`` unless given).

    Ids are **positional and stable**: row ``i`` of the float buffer is id
    ``i`` forever (upserts append, deletes tombstone, rebuilds keep dead
    rows in place). A sharded corpus is padded with tombstoned zero rows so
    every epoch splits evenly across ``shard_align`` (default ``shards``)
    shards; ``quantized`` in {"int8", "pq"} stores its shards compressed.
    ``rank`` (a process group's rank, sharded corpora only) builds that
    rank's shard of each epoch alone: shard ``rank`` of ``shards``, the
    group's first ranks serving, none on a rank past them.
    """

    def __init__(self, vectors=None, metric: str = "l2", *,
                 graph: FlatGraph | None = None,
                 delta_capacity: int = 256, M: int = 16,
                 builder: str = "knng", shards: int | None = None,
                 shard_align: int | None = None,
                 quantized: str | None = None, scale_rows: int = 8,
                 background: bool = True, seed: int = 0, device=None,
                 rank: int | None = None):
        if builder not in ("knng", "hnsw"):
            raise ValueError(f"unknown builder {builder!r}")
        refuse_unported(shards=shards, quantized=quantized)
        if delta_capacity < 1:
            raise ValueError(f"delta_capacity={delta_capacity} must be >= 1")
        self.device = resolve_device(device)
        if graph is not None:
            if vectors is not None:
                raise ValueError("pass either vectors or graph=, not both")
            if shards:
                raise ValueError("a sharded index is built from vectors — "
                                 "pass vectors=, not a single-host graph")
            if not (isinstance(graph.vectors, torch.Tensor)
                    and graph.vectors.is_floating_point()):
                raise ValueError(
                    "the mutable layer needs the exact float corpus "
                    "(certificates and rebuilds rescore it; contract 13)")
            base = graph.vectors.cpu().numpy()
            metric = graph.metric
        else:
            if vectors is None:
                raise ValueError("MutableIndex needs vectors or graph=")
            base = np.asarray(vectors, np.float32)
        if base.ndim != 2:
            raise ValueError("vectors must be a float [n, d] corpus")
        self.metric = str(metric)
        self.d = int(base.shape[1])
        self.delta_capacity = int(delta_capacity)
        self.M = int(M)
        self.builder = builder
        self.shards = int(shards) if shards else None
        #: elastic alignment: epochs pad to divisibility by the LARGEST
        #: shard count the serving layer may rescale to, so every prepared
        #: target splits the same rows evenly (defaults to ``shards``)
        self.shard_align = int(shard_align) if shard_align else None
        if self.shard_align is not None:
            if not self.shards:
                raise ValueError("shard_align only applies to sharded "
                                 "corpora (pass shards=)")
            if self.shard_align % self.shards:
                raise ValueError(
                    f"shard_align={self.shard_align} must be a multiple of "
                    f"shards={self.shards}")
        if rank is not None and not self.shards:
            raise ValueError("rank= builds a rank's shard of a sharded "
                             "corpus (pass shards=)")
        self.rank = rank
        self.quantized = quantized
        self.scale_rows = int(scale_rows)
        self.background = bool(background)
        self.seed = int(seed)
        # append-only storage (amortized-doubling buffer); row index == id
        n = int(base.shape[0])
        cap = max(64, 1 << int(np.ceil(np.log2(max(n + delta_capacity, 1)))))
        self._vecs = np.zeros((cap, self.d), np.float32)
        self._vecs[:n] = base
        self._del = np.zeros(cap, bool)
        self._n = n
        self.epoch = 0
        #: bumps on every write and on every swap — the one-token snapshot
        #: tag results are keyed by
        self.version = 0
        self.rebuilds = 0
        #: set on the first write and never cleared (tombstones persist
        #: across swaps); while False, harvests take the bit-exact fast path
        self.mutated = False
        self.num_deleted = 0
        if self.shards is not None:
            self._pad_for_shards()
        #: first id NOT covered by the current epoch's structure — rows at
        #: ``[delta_start, n)`` are the delta segment
        self.delta_start = self._n
        self._pending: tuple[int, object] | None = None
        self._thread: threading.Thread | None = None
        self._failure: Exception | None = None
        self._lock = threading.Lock()
        self._delta_codes: tuple[int, object] | None = None
        if self.shards is not None:
            self.graph = None
            self.sharded = self._build(self._vecs[:self._n].copy())
        else:
            self.sharded = None
            self.graph = (to_device(graph, self.device) if graph is not None
                          else self._build(base))

    # -- views ---------------------------------------------------------------
    @property
    def n_total(self) -> int:
        return self._n

    @property
    def deleted(self) -> np.ndarray:
        """Live deletion bitmap (bool[n_total] view)."""
        return self._del[:self._n]

    @property
    def delta_count(self) -> int:
        return self._n - self.delta_start

    @property
    def live_count(self) -> int:
        return self._n - self.num_deleted

    def float_view(self) -> np.ndarray:
        """The exact float corpus, all epochs + delta ([n_total, d] host
        view)."""
        return self._vecs[:self._n]

    def delta_ids(self) -> np.ndarray:
        """Live (non-tombstoned) ids in the delta segment."""
        tail = np.arange(self.delta_start, self._n, dtype=np.int64)
        return tail[~self._del[self.delta_start:self._n]]

    def stats(self) -> dict:
        return dict(n_total=self._n, live=self.live_count,
                    deleted=self.num_deleted, delta=self.delta_count,
                    delta_capacity=self.delta_capacity, epoch=self.epoch,
                    version=self.version, rebuilds=self.rebuilds,
                    rebuild_pending=self.swap_ready()
                    or (self._thread is not None and self._thread.is_alive()))

    # -- writes --------------------------------------------------------------
    def _grow(self, extra: int) -> None:
        need = self._n + extra
        if need <= self._vecs.shape[0]:
            return
        cap = self._vecs.shape[0]
        while cap < need:
            cap *= 2
        vecs = np.zeros((cap, self.d), np.float32)
        vecs[:self._n] = self._vecs[:self._n]
        dele = np.zeros(cap, bool)
        dele[:self._n] = self._del[:self._n]
        self._vecs, self._del = vecs, dele

    def upsert(self, vectors) -> np.ndarray:
        """Append fresh vectors; returns their assigned ids (int64[m]).

        Ids are always fresh — replacing an existing id is
        ``delete([id])`` + ``upsert(new_vector)``. Filling the delta past
        ``delta_capacity`` auto-requests a rebuild; past four capacities
        with a rebuild still pending it raises ``DeltaFull``.
        """
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        if vecs.ndim != 2 or vecs.shape[1] != self.d:
            raise ValueError(f"upsert expects [m, {self.d}] vectors")
        m = int(vecs.shape[0])
        if self.delta_count + m > 4 * self.delta_capacity:
            raise DeltaFull(
                f"delta {self.delta_count}+{m} past 4x capacity "
                f"{self.delta_capacity} with a rebuild still pending")
        self._grow(m)
        ids = np.arange(self._n, self._n + m, dtype=np.int64)
        self._vecs[self._n:self._n + m] = vecs
        self._del[self._n:self._n + m] = False
        self._n += m
        self.version += 1
        self.mutated = True
        self._delta_codes = None
        if self.delta_count >= self.delta_capacity:
            self.request_rebuild()
        return ids

    def delete(self, ids) -> int:
        """Tombstone ids in the live bitmap; returns how many were newly
        deleted. Unknown ids raise (a delete must never silently no-op)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return 0
        if (ids < 0).any() or (ids >= self._n).any():
            raise KeyError(f"delete of unknown id(s) outside [0, {self._n})")
        newly = int((~self._del[ids]).sum())
        self._del[ids] = True
        self.num_deleted += newly
        self.version += 1
        self.mutated = True
        self._delta_codes = None
        return newly

    # -- scoring (kernels/ops ladder) -----------------------------------------
    def _score_rows(self, q, ids: np.ndarray, impl: str | None):
        """Exact float scores of host rows ``ids`` against ``q``: the rows
        move to the device and one similarity launch scores them."""
        if ids.size == 0:
            return np.zeros(0, np.float32)
        q32 = torch.from_numpy(np.asarray(q, np.float32).reshape(-1))
        rows = theorems.frontier_rows(self._vecs, ids, self.device)
        return kops.batch_similarity(q32.to(self.device), rows, self.metric,
                                     impl=impl).cpu().numpy()

    def _delta_int8(self, ids: np.ndarray):
        """Int8 codes of the live delta rows on the device (rebuilt lazily
        after each write)."""
        if self._delta_codes is not None \
                and self._delta_codes[0] == self.version:
            return self._delta_codes[1]
        corp = quant.quantize_corpus(self._vecs[ids], "int8",
                                     scale_rows=self.scale_rows,
                                     device=self.device)
        self._delta_codes = (self.version, corp)
        return corp

    def score_delta(self, q, *, impl: str | None = None):
        """Flat-score the live delta segment: ``(ids, float_scores)``, one
        batched launch through the ``kernels.ops`` ladder; the fixed
        capacity keeps "all rows" cheap by construction. An int8 corpus
        also scores the delta's int8 codes (``quantized_similarity_many``,
        the pass a capped prefilter would rank by), but the scores returned
        are always the exact float ones (contract 13)."""
        ids = self.delta_ids()
        if ids.size and self.quantized == "int8":
            q32 = torch.from_numpy(np.asarray(q, np.float32).reshape(1, -1))
            kops.quantized_similarity_many(q32.to(self.device),
                                           self._delta_int8(ids),
                                           self.metric, impl=impl)
        return ids, self._score_rows(q, ids, impl)

    # -- harvest-time merge + audit ------------------------------------------
    def audit_frontier(self, q, k: int, eps: float, cand_ids,
                       cand_scores=None, *, max_expansions: int = 100_000,
                       impl: str | None = None):
        """Merge a recorded frontier with the live delta, apply the bitmap,
        and re-run the Theorem-2 audit against the live corpus.

        ``cand_scores=None`` rescores the frontier rows against ``q`` (the
        semantic cache's revalidation path, where the query drifted);
        otherwise the scores are trusted as ``q``'s exact float scores.
        Returns ``(certified, sel_ids[k], sel_scores[k], merged_ids,
        merged_scores, slack)`` — certification uses
        ``max(s_K_merged, s_K_frontier)`` so the engine's bound on
        unexplored graph points survives delta points extending the
        frontier below it.
        """
        cand_ids = np.asarray(cand_ids, np.int64).reshape(-1)
        valid = (cand_ids >= 0) & (cand_ids < self._n)
        # padding in the recorded frontier == the graph was exhausted, so
        # there are no unexplored graph points to bound (s_K = -inf)
        exhausted = cand_ids.size == 0 or bool((cand_ids < 0).any())
        g_ids = cand_ids[valid]
        if cand_scores is None:
            g_sc = self._score_rows(q, g_ids, impl)
        else:
            g_sc = np.asarray(cand_scores, np.float32).reshape(-1)[valid]
        s_K_bound = (-np.inf if exhausted or g_ids.size == 0
                     else float(g_sc.min()))
        live = ~self._del[g_ids] if g_ids.size else np.zeros(0, bool)
        g_ids, g_sc = g_ids[live], g_sc[live]
        d_ids, d_sc = self.score_delta(q, impl=impl)
        if d_ids.size and g_ids.size:
            fresh = ~np.isin(d_ids, g_ids)  # post-write frontiers may
            d_ids, d_sc = d_ids[fresh], d_sc[fresh]  # already hold delta ids
        ids = np.concatenate([g_ids, d_ids])
        sc = np.concatenate([g_sc, d_sc]).astype(np.float32)
        if ids.size == 0:
            return (False, np.full(k, -1, np.int32),
                    np.zeros(k, np.float32), ids.astype(np.int32), sc,
                    -np.inf)
        order = np.lexsort((ids, -sc))   # score desc, id asc (repo-wide tie)
        ids, sc = ids[order], sc[order]

        def audit(k_):
            return theorems.theorem2_audit(
                self.float_view(), self.metric, ids, sc, eps, k_,
                max_expansions=max_expansions, device=self.device, impl=impl)

        cert_a, sel_ids, min_value, s_K_a = audit(k)
        if (sel_ids < 0).all():
            # deletions can leave fewer than k live candidates (or no
            # feasible size-k diverse set): serve the largest feasible
            # diverse set instead of nothing — never certified at k
            k_eff = min(k - 1, int(ids.size))
            while k_eff >= 1:
                _, sel_small, _, _ = audit(k_eff)
                if not (sel_small < 0).all():
                    sel_ids = np.concatenate(
                        [sel_small,
                         np.full(k - k_eff, -1, sel_small.dtype)])
                    break
                k_eff -= 1
            cert_a, min_value = False, -np.inf
        s_K_eff = max(s_K_a, s_K_bound)
        certified = bool(cert_a and min_value > s_K_eff)
        slack = float(min_value - s_K_eff)
        score_of = dict(zip(ids.tolist(), sc.tolist()))
        sel_sc = np.asarray([score_of.get(int(i), 0.0) if i >= 0 else 0.0
                             for i in sel_ids], np.float32)
        return (certified, sel_ids.astype(np.int32), sel_sc,
                ids.astype(np.int32), sc, slack)

    def finalize(self, q, k: int, eps: float, result: DiverseResult,
                 frontier, *, max_expansions: int = 100_000,
                 impl: str | None = None):
        """Post-process one harvested lane against the live corpus view.

        Returns ``(result, (merged_ids, merged_scores, slack_or_None),
        meta)`` where ``meta = dict(epoch=..., version=...)`` tags the
        snapshot the result is valid against. With no writes ever applied
        the engine's output passes through bit-exactly.
        """
        meta = dict(epoch=self.epoch, version=self.version)
        if not self.mutated and frontier is not None:
            rec = (np.asarray(frontier[0]), np.asarray(frontier[1]),
                   frontier[2] if len(frontier) > 2 else None)
            return result, rec, meta
        if frontier is None:
            # no recorded certificate frontier (e.g. a pgs lane finishing
            # in-round): bitmap-filter the served set; the delta cannot be
            # merged without a frontier, so any mutation voids the
            # certificate rather than over-claiming
            ids = np.asarray(result.ids)
            live = (ids >= 0) & ~self._del[np.maximum(ids, 0)]
            if not self.mutated or (live == (ids >= 0)).all():
                certified = result.stats.certified and self.delta_count == 0
                if certified == result.stats.certified:
                    return result, None, meta
                stats = dataclasses.replace(result.stats, certified=False)
                return (DiverseResult(result.ids, result.scores,
                                      result.total, stats), None, meta)
            out_ids, out_sc = _compact_served(
                ids, np.asarray(result.scores, np.float32), live)
            stats = dataclasses.replace(result.stats, certified=False)
            return (DiverseResult(out_ids, out_sc, float(out_sc.sum()),
                                  stats), None, meta)
        certified, sel_ids, sel_sc, m_ids, m_sc, slack = self.audit_frontier(
            q, k, eps, frontier[0], frontier[1],
            max_expansions=max_expansions, impl=impl)
        stats = dataclasses.replace(result.stats, certified=certified,
                                    div_calls=result.stats.div_calls + 1)
        res = DiverseResult(sel_ids, sel_sc, float(sel_sc.sum()), stats)
        return res, (m_ids, m_sc, slack if certified else None), meta

    # -- rebuild + epoch swap ------------------------------------------------
    def _pad_for_shards(self) -> None:
        pad = (-self._n) % (self.shard_align or self.shards)
        if pad:
            self._grow(pad)
            self._del[self._n:self._n + pad] = True  # permanent tombstones
            self.num_deleted += pad
            self._n += pad

    def _build(self, snap: np.ndarray):
        """Build the epoch structure over a row snapshot on the index's
        device (thread-safe: a pure function of ``snap``; tombstoned rows
        stay in place so ids remain positional)."""
        if self.shards is not None:
            from repro_torch.sharded_search.search import build_sharded_index
            shards = self.shards
            shard = (None if self.rank is None
                     else self.rank if self.rank < shards else -1)
            return build_sharded_index(
                snap, shards, self.metric, M=self.M,
                builder=self.builder, quantized=self.quantized,
                scale_rows=self.scale_rows, seed=self.seed,
                device=self.device, shard=shard)
        if self.builder == "hnsw":
            from repro_torch.index.hnsw import build_hnsw
            return build_hnsw(snap, self.metric, M=self.M, seed=self.seed,
                              device=self.device)
        from repro_torch.index.flat import build_knn_graph
        return build_knn_graph(snap, self.metric, M=self.M,
                               device=self.device)

    def request_rebuild(self, *, background: bool | None = None) -> bool:
        """Kick off a rebuild over the current rows; returns True if one was
        started (False: one is already running or awaiting its swap).

        ``background=True`` builds on a thread, so serving keeps pumping;
        the built structure is *installed* only by ``install_swap`` — the
        serving layer's between-rounds barrier — never here. A build that
        raises on the thread is raised again by the next ``swap_ready`` or
        ``wait_rebuild``.
        """
        with self._lock:
            if self._pending is not None:
                return False
            if self._thread is not None and self._thread.is_alive():
                return False
        if self.shards is not None:
            self._pad_for_shards()
        n_snap = self._n
        snap = self._vecs[:n_snap].copy()

        def work():
            try:
                art = self._build(snap)
            except Exception as e:   # raised again on the serving side
                with self._lock:
                    self._failure = e
                return
            with self._lock:
                self._pending = (n_snap, art)

        if self.background if background is None else background:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
        return True

    def _raise_failure(self) -> None:
        """Raise, once, the exception a background build ended with."""
        with self._lock:
            failure, self._failure = self._failure, None
        if failure is not None:
            raise RuntimeError("the background rebuild failed") from failure

    def wait_rebuild(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_failure()

    def swap_ready(self) -> bool:
        self._raise_failure()
        with self._lock:
            return self._pending is not None

    def install_swap(self):
        """Adopt the pending structure as the new epoch; returns it.

        Callers (``MutableBackend.maybe_swap``) must hold the engine idle —
        this only flips the index's own pointers.
        """
        with self._lock:
            if self._pending is None:
                raise RuntimeError("no rebuilt structure pending")
            n_snap, art = self._pending
            self._pending = None
        if self.shards is not None:
            self.sharded = art
        else:
            self.graph = art
        self.delta_start = n_snap
        self.epoch += 1
        self.version += 1
        self.rebuilds += 1
        self._delta_codes = None
        return art


class MutableBackend:
    """``LaneBackend`` decorator adding the write path to the engine.

    Defines every protocol member itself (a ``__getattr__`` delegation would
    not satisfy ``isinstance(..., LaneBackend)`` under Python 3.12) and
    adds, at harvest, the live merge (``MutableIndex.finalize``: bitmap
    filter + delta merge + Theorem-2 re-audit), publishing the *merged*
    frontier in its own ``last_candidates`` so cache admission sees
    live-valid certificates. ``free_lanes`` is the epoch-swap barrier: while
    a rebuilt structure is pending it admits nothing, lets in-flight lanes
    drain, and installs the swap on the idle engine between rounds
    (contract 15).

    Constructed over a ``RescalableBackend`` (a ``ShardedEngine``) it is a
    ``RescalableMutableBackend``, which defines the rescale members too;
    over any other engine it has none. So it is a ``RescalableBackend``
    exactly when its engine is one.
    """

    def __new__(cls, inner, index: MutableIndex):
        if cls is MutableBackend and isinstance(inner, RescalableBackend):
            cls = RescalableMutableBackend
        return super().__new__(cls)

    def __init__(self, inner, index: MutableIndex):
        self.inner = inner
        self.mutable_index = index
        inner.record_candidates = True
        self.last_candidates: list = [None] * int(inner.num_lanes)
        #: per-lane ``dict(epoch=..., version=...)`` snapshot tag of the
        #: last finalized harvest (audits key corpus state by it)
        self.last_meta: list = [None] * int(inner.num_lanes)
        self.swaps = 0
        #: swaps whose rebuilt epoch was resharded onto the serving count
        self.reshards = 0
        self._reqs: dict[int, object] = {}

    # -- protocol delegation -------------------------------------------------
    @property
    def num_lanes(self) -> int:
        return self.inner.num_lanes

    @property
    def max_k(self) -> int:
        return self.inner.max_k

    @property
    def default_ef(self) -> int:
        return self.inner.default_ef

    @property
    def methods(self):
        return self.inner.methods

    @property
    def compressed(self) -> bool:
        return self.inner.compressed

    @property
    def bytes_per_vector(self) -> float:
        return self.inner.bytes_per_vector

    @property
    def signature_log(self):
        return self.inner.signature_log

    @property
    def record_candidates(self) -> bool:
        return True

    @record_candidates.setter
    def record_candidates(self, value) -> None:
        pass   # the merge *requires* frontiers; the inner flag stays True

    def active_count(self) -> int:
        return self.inner.active_count()

    def step(self):
        return self.inner.step()

    def prewarm(self, **kw) -> None:
        self.inner.prewarm(**kw)

    @property
    def mesh(self):
        return getattr(self.inner, "mesh", None)

    # -- the write-aware surface ---------------------------------------------
    def write(self, op: str, payload) -> np.ndarray:
        """Apply one corpus write to the mutable index: ``"upsert"`` of
        ``[m, d]`` vectors returns their ids, ``"delete"`` the ids it
        named."""
        if op == "upsert":
            return self.mutable_index.upsert(payload)
        ids = np.asarray(payload, np.int64).reshape(-1)
        self.mutable_index.delete(ids)
        return ids

    def request_rebuild(self) -> bool:
        """``MutableIndex.request_rebuild`` on the backend's index."""
        return self.mutable_index.request_rebuild()

    def maybe_swap(self) -> bool:
        """Install a pending epoch swap if the engine is idle (between
        rounds, no occupied lanes); returns True when a swap landed."""
        if not self.mutable_index.swap_ready():
            return False
        if self.inner.active_count():
            return False
        return self._install()

    def follow_swap(self) -> None:
        """Install the swap rank 0 decided: wait for this rank's own
        rebuild (it may still be building), then install it."""
        self.mutable_index.wait_rebuild()
        if self.inner.active_count() or not self.mutable_index.swap_ready():
            raise RuntimeError("rank 0 swapped an epoch this rank cannot "
                               "install (lanes occupied or no rebuild)")
        self._install()

    def _install(self) -> bool:
        index = self.mutable_index
        art = index.install_swap()
        if index.shards is None:
            self.inner.swap_graph(art)
            self.swaps += 1
            return True
        # the engine's rerank corpus is the epoch snapshot: the rows the new
        # index covers, not delta rows appended since
        n_epoch = art.num_shards * art.shard_size
        if art.num_shards != self.inner.num_shards:
            # a rescale landed while the background rebuild ran: the rebuilt
            # epoch targets the old shard count — repartition it onto the
            # serving one (same rows, exact re-blocking)
            from repro_torch.sharded_search.search import (rank_shard,
                                                           reshard_index)
            art = reshard_index(art, int(self.inner.num_shards),
                                index.float_view()[:n_epoch], M=index.M,
                                builder=index.builder,
                                shard=rank_shard(self.inner.mesh))
            index.sharded = art
            index.shards = int(self.inner.num_shards)
            self.reshards += 1
        self.inner.swap_index(art, index.float_view()[:n_epoch])
        self.swaps += 1
        return True

    def free_lanes(self):
        if self.mutable_index.swap_ready() and not self.maybe_swap():
            return np.zeros(0, np.int64)   # drain: swap barrier is pending
        return self.inner.free_lanes()

    def admit(self, lane: int, request) -> None:
        self._reqs[int(lane)] = request
        self.inner.admit(lane, request)

    def harvest(self):
        out = []
        for lane, result in self.inner.harvest():
            req = self._reqs.get(int(lane))
            frontier = self.inner.last_candidates[lane]
            res, merged, meta = self.mutable_index.finalize(
                req.q, int(req.k), float(req.eps), result, frontier)
            self.last_candidates[int(lane)] = merged
            self.last_meta[int(lane)] = meta
            out.append((lane, res))
        return out

    def recycle(self, lane: int) -> None:
        self._reqs.pop(int(lane), None)
        self.inner.recycle(lane)


class RescalableMutableBackend(MutableBackend):
    """A ``MutableBackend`` over a ``RescalableBackend``: the rescale
    members are delegated to the engine, spelled out so that Python 3.12's
    static protocol check sees them. A rescale also moves the mutable
    index's epoch to the new shard count (later rebuilds target it) and
    resizes the merged-frontier slots to the engine's lane count."""

    @property
    def num_shards(self) -> int:
        return self.inner.num_shards

    @property
    def rescale_gathered_bytes(self) -> int:
        return self.inner.rescale_gathered_bytes

    def prepare_rescale(self, shards: int, mesh, index=None, **kw):
        return self.inner.prepare_rescale(shards, mesh, index, **kw)

    def rescale_options(self) -> tuple[int, ...]:
        return self.inner.rescale_options()

    def rescale(self, shards: int) -> bool:
        if not self.inner.rescale(shards):
            return False
        if self.mutable_index.shards is not None:
            self.mutable_index.shards = int(shards)
            self.mutable_index.sharded = self.inner.index
        B = int(self.inner.num_lanes)
        for slots in (self.last_candidates, self.last_meta):
            del slots[B:]
            slots.extend([None] * (B - len(slots)))
        return True
