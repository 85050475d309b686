"""Semantic result cache with Theorem-2 certificate revalidation (port of
``repro.serve.cache``).

Production traffic is heavily duplicated: near-identical queries arrive
seconds apart, and each one pays a full progressive search even though a
certified diverse set for "the same" query was just computed. This module
caches certified result sets keyed by query embedding and serves a
*revalidated* copy on a near-hit — the latency lever the scheduler pulls
before a request ever occupies a lane.

Soundness (contract 14, ``docs/ARCHITECTURE.md``): the cache is a latency
knob, never a results-soundness knob. Every entry stores the candidate
frontier its Theorem-2 certificate was computed over, and a hit is served
only after that frontier is **rescored in exact float against the live
query** and passes :func:`repro_torch.core.theorems.theorem2_recheck`. The
probe threshold (``theorem2_slack_threshold``: certificate slack / (2k·L),
with L the metric's score-Lipschitz constant per unit query drift) is a
*probe filter* that predicts which entries can survive revalidation; it is
never the soundness argument, because the recheck runs on every hit.

Device work: the probe is one ``kops.batch_similarity`` launch of the live
query against every cached embedding (kept on the device, rebuilt after an
admission or eviction); revalidation gathers only the entry's frontier rows
(on the host for a host corpus) and rescores them with the same op, then
audits them (one adjacency launch at B = 1, div-A* on the host).

Eviction is LRU gated by slack-aware admission: a new entry may only
displace the least-recently-used entry among residents whose revalidation
threshold does not exceed its own — a cache full of strictly
more-reusable entries declines the newcomer rather than churn.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import theorems
from repro_torch.core.pgs import DiverseResult
from repro_torch.core.progressive import SearchStats
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(eq=False)
class CacheEntry:
    """One cached certified result: the served set, the frontier its
    certificate was computed over, and the reuse budget derived from it."""
    q_probe: np.ndarray        # probe-space query (unit-normalized for cos)
    q: np.ndarray              # the original query embedding
    k: int
    eps: float
    method: str
    ids: np.ndarray            # served diverse set (global ids)
    scores: np.ndarray
    cand_ids: np.ndarray       # certificate frontier (global ids, -1 pad)
    cand_scores: np.ndarray    # frontier scores for the original query
    slack: float               # minValue - s_K at admission
    threshold: float           # max probe-space drift worth rechecking
    hits: int = 0

    @property
    def key(self) -> tuple:
        """Compatibility key — a hit must share the request's exact
        diversification parameters (Definition 1: the query owns them)."""
        return (int(self.k), float(self.eps), str(self.method))


class SemanticResultCache:
    """Certified diverse result sets keyed by query embedding.

    ``vectors`` must be the **exact float corpus**, a host array or a
    tensor (revalidation rescores frontiers with it; handing it a quantized corpus would launder
    quantization error into certificates — contract 13 forbids that).
    ``capacity`` bounds resident entries; ``max_drift`` optionally caps the
    probe threshold (useful for ``k == 1``, whose Theorem-2 slack is
    infinite); ``impl`` pins the kernel ladder rung for probes and
    rescoring (None = the ambient default). ``safety`` in ``(0, 1]``
    shrinks thresholds below the proven bound.

    ``guard`` is a numerical guard band (score units): admission rejects
    certificates whose slack is within it, and revalidation requires the
    live recheck's margin ``min_value - s_K`` to clear it. The slack
    threshold's soundness argument assumes exact arithmetic; a knife-edge
    certificate (slack ~ float noise) can flip verdict under a different
    but equally exact summation order — e.g. an auditor rescoring the
    frontier through another kernel rung. The guard keeps every served
    hit's certificate far enough from the boundary that *any* independent
    float path reaches the same verdict.

    ``live`` binds the cache to a mutable corpus (an
    ``index.mutable.MutableIndex``; pass ``vectors=None``): revalidation
    then runs through ``live.audit_frontier`` — deletion-bitmap filter,
    delta-segment merge, Theorem-2 re-audit against the live float view —
    so a hit after a write is either served valid-against-the-live-corpus
    or refused (contract 15 extends contract 14). The ``ip`` Lipschitz
    constant tracks the live corpus per write version. ``invalidate`` is
    the eager companion: the scheduler's write path evicts entries whose
    stored frontier a write touched, independent of live binding.

    The cache's device work runs where a tensor corpus lies, else on the
    live index's device, else on ``device`` (``cuda`` unless given).
    """

    def __init__(self, vectors, metric: str | None = None,
                 capacity: int = 256, *,
                 live=None, impl: str | None = None, safety: float = 1.0,
                 max_drift: float | None = None, guard: float = 1e-4,
                 device=None):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        if not 0.0 < safety <= 1.0:
            raise ValueError(f"safety={safety} outside (0, 1] — above 1 the "
                             "threshold would exceed the proven drift bound")
        if guard < 0.0:
            raise ValueError(f"guard={guard} must be >= 0")
        self.live = live
        if live is not None:
            if vectors is not None:
                raise ValueError("pass either vectors or live=, not both")
            metric = live.metric
            self._vectors = None
            self.device = live.device
        else:
            if isinstance(vectors, torch.Tensor):
                self._vectors = vectors.to(torch.float32)
                self.device = self._vectors.device
            else:
                self._vectors = np.asarray(vectors, np.float32)
                self.device = resolve_device(device)
            if self._vectors.ndim != 2:
                raise ValueError("vectors must be the float [n, d] corpus")
            if metric is None:
                raise ValueError("metric is required with a static corpus")
        self.metric = str(metric)
        self.capacity = int(capacity)
        self.impl = impl
        self.safety = float(safety)
        self.max_drift = None if max_drift is None else float(max_drift)
        self.guard = float(guard)
        self._lip_cache: tuple[int, float] | None = None
        #: eid -> entry, ordered oldest-touched first (LRU at the front)
        self._entries: collections.OrderedDict[int, CacheEntry] = \
            collections.OrderedDict()
        self._next_eid = 0
        self._qmat: torch.Tensor | None = None   # (m, d) probe-space rows
        self._eids: list[int] = []
        self.probes = 0
        self.hits = 0
        self.misses = 0
        self.revalidation_failures = 0
        self.admitted = 0
        self.rejected = 0
        self.evicted = 0
        self.invalidated = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def vectors(self):
        """The exact float corpus revalidation rescores against — the live
        view when bound to a mutable index, else the static corpus."""
        return (self.live.float_view() if self.live is not None
                else self._vectors)

    @property
    def lipschitz(self) -> float:
        """Score-shift per unit probe drift (see
        ``theorem2_slack_threshold``): l2 and cos are 1-Lipschitz in probe
        space; ip is bounded by the largest corpus norm — recomputed per
        write version on a live corpus (an upsert can raise it)."""
        if self.metric != "ip":
            return 1.0
        version = self.live.version if self.live is not None else 0
        if self._lip_cache is None or self._lip_cache[0] != version:
            v = self.vectors
            norms = (torch.linalg.vector_norm(v, dim=1)
                     if isinstance(v, torch.Tensor)
                     else np.linalg.norm(v, axis=1))
            self._lip_cache = (version, float(norms.max())
                               if norms.shape[0] else 1.0)
        return self._lip_cache[1]

    # -- probe space ---------------------------------------------------------
    def _probe_vec(self, q) -> np.ndarray:
        q = np.asarray(q, np.float32).reshape(-1)
        if self.metric == "cos":
            n = float(np.linalg.norm(q))
            if n > 0.0:
                q = q / n
        return q

    def _rebuild_qmat(self) -> None:
        self._eids = list(self._entries)
        self._qmat = (torch.from_numpy(np.stack(
            [self._entries[e].q_probe for e in self._eids])).to(self.device)
            if self._eids else None)

    # -- lookup --------------------------------------------------------------
    def lookup(self, q, k: int, eps: float, method: str):
        """Probe + revalidate: returns ``(DiverseResult, CacheEntry)`` for a
        revalidated near-hit, or ``None`` (miss, or revalidation failed).
        The returned result's scores are the *live query's* exact float
        scores over the entry's frontier, and its certificate was re-audited
        against the live query — never the cached one."""
        self.probes += 1
        eid = self._probe(q, k, eps, method)
        if eid is None:
            self.misses += 1
            return None
        entry = self._entries[eid]
        result = self.revalidate(entry, q)
        if result is None:
            self.revalidation_failures += 1
            self.misses += 1
            return None
        self.hits += 1
        entry.hits += 1
        self._entries.move_to_end(eid)
        return result, entry

    def _probe(self, q, k: int, eps: float, method: str) -> int | None:
        if not self._entries:
            return None
        if self._qmat is None:
            self._rebuild_qmat()
        key = (int(k), float(eps), str(method))
        qp = self._probe_vec(q)
        # one batched kernel dispatch against every cached embedding; the
        # l2 similarity is 1 - ||qp - qi||, so drift falls straight out
        sims = kops.batch_similarity(
            torch.from_numpy(qp).to(self.device), self._qmat, "l2",
            impl=self.impl).cpu().numpy()
        drifts = np.maximum(1.0 - sims.astype(np.float64), 0.0)
        best: tuple | None = None
        for row, eid in enumerate(self._eids):
            entry = self._entries[eid]
            if entry.key != key:
                continue
            limit = entry.threshold
            if self.max_drift is not None:
                limit = min(limit, self.max_drift)
            drift = float(drifts[row])
            if drift > limit:
                continue
            cand = (drift, eid)         # nearest first; oldest eid breaks ties
            if best is None or cand < best:
                best = cand
        return best[1] if best is not None else None

    # -- revalidation --------------------------------------------------------
    def revalidate(self, entry: CacheEntry, q) -> DiverseResult | None:
        """Rescore the entry's frontier against ``q`` in exact float and
        re-run the Theorem-2 recheck; a pass returns a ``DiverseResult``
        carrying the live query's scores and a live certificate. The
        recheck's margin must clear ``guard``, so the certificate survives
        an independent auditor's float path too (not just this one).

        On a live (mutable) corpus with writes applied, the recheck runs
        through ``live.audit_frontier`` instead: tombstoned ids are dropped
        from the frontier, the delta segment's live points are merged in
        (a fresh better point must *join* the served set, not silently
        lose to a stale one), and the certificate is audited against the
        live float view with the engine's unexplored-point bound kept."""
        if self.live is not None and self.live.mutated:
            certified, sel_ids, sel_sc, m_ids, _, slack = \
                self.live.audit_frontier(q, entry.k, entry.eps,
                                         entry.cand_ids, None,
                                         impl=self.impl)
            if not certified or not slack > self.guard:
                return None
            stats = SearchStats(expansions=0, growths=0, search_calls=0,
                                div_calls=1, certified=True, exhausted=False,
                                K_final=int(m_ids.size))
            return DiverseResult(sel_ids.astype(np.int32), sel_sc,
                                 float(sel_sc.sum()), stats)
        valid = entry.cand_ids >= 0
        vecs = theorems.frontier_rows(self.vectors,
                                      np.maximum(entry.cand_ids, 0),
                                      self.device)
        q32 = torch.from_numpy(np.asarray(q, np.float32).reshape(-1))
        sc = kops.batch_similarity(q32.to(self.device), vecs, self.metric,
                                   impl=self.impl).cpu().numpy()
        sc = np.where(valid, sc, -np.inf).astype(np.float32)
        order = np.argsort(-sc, kind="stable")
        new_ids = entry.cand_ids[order]
        new_sc = sc[order]
        certified, sel_ids, min_value, s_K = theorems.theorem2_audit(
            self.vectors, self.metric, new_ids, new_sc, entry.eps, entry.k,
            device=self.device, impl=self.impl)
        if not certified or not (min_value - s_K) > self.guard:
            return None
        score_of = {int(i): float(s) for i, s in zip(new_ids, new_sc)
                    if i >= 0}
        sel_sc = np.asarray([score_of.get(int(i), 0.0) if i >= 0 else 0.0
                             for i in sel_ids], np.float32)
        stats = SearchStats(expansions=0, growths=0, search_calls=0,
                            div_calls=1, certified=True, exhausted=False,
                            K_final=int(valid.sum()))
        return DiverseResult(sel_ids.astype(np.int32), sel_sc,
                             float(sel_sc.sum()), stats)

    # -- admission -----------------------------------------------------------
    def admit_request(self, q, k: int, eps: float, method: str,
                      result: DiverseResult, cand_ids, cand_scores,
                      slack: float | None = None) -> bool:
        """Offer a harvested result for caching; returns True if admitted.

        Only certified results with a recorded frontier and positive
        Theorem-2 slack are cacheable. ``slack`` may be supplied by the
        engine (it computed ``minValue - s_K`` in its final round); when
        absent it is re-derived by an independent ``theorem2_audit`` of the
        frontier — which also refuses frontiers whose certificate was not
        Theorem-2-shaped (e.g. ``pds``'s Theorem-1 budget certificates).
        """
        if result is None or not getattr(result.stats, "certified", False):
            self.rejected += 1
            return False
        if cand_ids is None or cand_scores is None:
            self.rejected += 1
            return False
        cand_ids = np.asarray(cand_ids, np.int32)
        cand_scores = np.asarray(cand_scores, np.float32)
        if cand_ids.size == 0 or not (cand_ids >= 0).any():
            self.rejected += 1
            return False
        if slack is None:
            certified, _, min_value, s_K = theorems.theorem2_audit(
                self.vectors, self.metric, cand_ids, cand_scores, eps, k,
                device=self.device, impl=self.impl)
            if not certified:
                self.rejected += 1
                return False
            slack = min_value - s_K
        slack = float(slack)
        if not slack > self.guard:      # knife-edge certificate: not worth
            self.rejected += 1          # caching, and an independent float
            return False                # path could flip its verdict
        threshold = self.safety * theorems.theorem2_slack_threshold(
            slack, k, self.lipschitz)
        if not threshold > 0.0:
            self.rejected += 1
            return False
        entry = CacheEntry(
            q_probe=self._probe_vec(q),
            q=np.asarray(q, np.float32).reshape(-1).copy(),
            k=int(k), eps=float(eps), method=str(method),
            ids=np.asarray(result.ids, np.int32).copy(),
            scores=np.asarray(result.scores, np.float32).copy(),
            cand_ids=cand_ids.copy(), cand_scores=cand_scores.copy(),
            slack=slack, threshold=float(threshold))
        if len(self._entries) >= self.capacity:
            # LRU among residents no more reusable than the newcomer; a
            # cache full of strictly larger thresholds declines instead
            victim = next((eid for eid in self._entries
                           if self._entries[eid].threshold
                           <= entry.threshold), None)
            if victim is None:
                self.rejected += 1
                return False
            del self._entries[victim]
            self.evicted += 1
        self._entries[self._next_eid] = entry
        self._next_eid += 1
        self.admitted += 1
        self._qmat = None   # rebuilt lazily on the next probe
        return True

    # -- write invalidation --------------------------------------------------
    def invalidate(self, ids) -> int:
        """Evict every entry whose stored certificate frontier intersects
        ``ids``; returns the eviction count. The scheduler's write path
        calls this on each applied write: a deleted id
        in a frontier voids both the served set and the slack the probe
        threshold was derived from. Upserted ids are fresh — no stored
        frontier can contain them — so upserts are covered by live-corpus
        revalidation (delta merge at hit time) rather than eager eviction.
        """
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        if ids.size == 0 or not self._entries:
            return 0
        victims = [eid for eid, e in self._entries.items()
                   if np.isin(e.cand_ids[e.cand_ids >= 0], ids).any()]
        for eid in victims:
            del self._entries[eid]
        if victims:
            self._qmat = None
            self.invalidated += len(victims)
        return len(victims)

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        """Counters snapshot (all lifetime): probes/hits/misses,
        revalidation failures (near-hits whose live-query recheck failed),
        admissions/rejections/evictions, write invalidations, and resident
        size."""
        return dict(
            size=len(self._entries), capacity=self.capacity,
            probes=self.probes, hits=self.hits, misses=self.misses,
            hit_rate=self.hits / self.probes if self.probes else 0.0,
            revalidation_failures=self.revalidation_failures,
            admitted=self.admitted, rejected=self.rejected,
            evicted=self.evicted, invalidated=self.invalidated,
        )

    @classmethod
    def for_backend(cls, backend, capacity: int = 256,
                    **kw) -> "SemanticResultCache":
        """Build a cache over a ``LaneBackend``'s own corpus.

        Works for any backend exposing a float corpus: a write-capable
        backend's ``mutable_index`` (the cache binds ``live=`` to it, so
        revalidation tracks writes), the single-host engine's ``graph``
        (``vectors``/``metric``, left on the engine's device), or the
        sharded engine's ``all_vectors`` + ``index.metric`` (on the index's
        device). Refuses quantized corpora — the cache must rescore in
        exact float (contract 13/14)."""
        mutable = getattr(backend, "mutable_index", None)
        if mutable is not None:
            return cls(None, capacity=capacity, live=mutable, **kw)
        graph = getattr(backend, "graph", None)
        if graph is not None and not getattr(backend, "compressed", False):
            return cls(graph.vectors, graph.metric, capacity, **kw)
        all_vectors = getattr(backend, "all_vectors", None)
        index = getattr(backend, "index", None)
        if all_vectors is not None and index is not None:
            kw.setdefault("device", index.device)
            return cls(np.asarray(all_vectors), index.metric, capacity, **kw)
        raise ValueError(
            "backend exposes no exact float corpus to revalidate against "
            "(quantized single-host corpora are refused: contract 13)")
