"""Continuous-batching lane scheduler — the serving layer over a LaneBackend
(port of ``repro.serve.scheduler``: the same admission, batching and
write-path decisions, host-side).

Top layer of the lane-state / backend / scheduler / policy split. A backend
(``core.backend.LaneBackend``) advances a fixed set of lanes one progressive
round per ``step()``; this module decides *which request occupies which lane
when* — and it is backend-neutral: the same scheduler drives the single-host
``core.batch_progressive.ProgressiveEngine`` and the mesh-sharded
``sharded_search.engine.ShardedEngine``.

* **Admission queue** — requests carry their own ``(k, eps, ef, method)``
  (the paper's Definition 1: the query owns its diversification level; no
  index rebuild) plus a ``tenant`` label. ``submit`` enqueues; a bounded
  queue gives backpressure (``SchedulerSaturated``) so callers can shed or
  defer load, and an optional ``shed`` callback lets a custom policy drop
  requests at submit time before they ever occupy a lane.
* **Admission policies** (``serve.policies``) — the queue is drained by a
  pluggable, cost-aware policy: ``"fifo"`` (default — submission order,
  bit-exactly the historical behavior), ``"drr"`` (deficit round-robin
  across tenants, deficit charged in *predicted expansions*), or
  ``"slo_cost"`` (shed / defer / earliest-deadline-first from predicted
  service time vs per-tenant SLO budgets). Policies read an online
  ``ExpansionCostModel`` that the scheduler updates from every harvested
  result's real ``SearchStats`` counters.
* **Continuous batching** — whenever a lane certifies (or exhausts), its
  slot is recycled for the next policy-selected request *between backend
  steps*, while sibling lanes keep their in-flight state. Div-A* trip
  counts are heavy-tailed by design, so under lockstep admission one hard
  query stalls a whole batch; continuous admission keeps every lane busy
  and cuts p99 latency on skewed workloads
  (``benchmarks/batch_bench.py --mode skewed`` measures both policies;
  ``--mode open`` drives Poisson arrivals against either backend with any
  admission policy).
* **Startup** — the scheduler pre-warms the backend's power-of-two shape
  ladder at construction (so every kernel is built before serving) and
  exposes the backend's ``SignatureLog`` for shape-class auditing.
* **Per-request stats** — wait (submit→admit), service (admit→done), and
  total latency per request, with p50/p99 summaries, Jain's fairness index,
  and the same broken out per tenant.

Parity contract (single-host backend): a request's result is the one a
lockstep ``batch_pss``/``batch_pgs``/``batch_pds`` lane gives for that query
— lane recycling starts from a fresh lane state and every engine op is
lane-separable, so admission order cannot leak between requests (this is
also why switching admission *policies* can change latencies but never
results). ``tests/test_torch_scheduler.py`` holds the scheduler against the
reference's. See ``docs/ARCHITECTURE.md`` for the full contract map.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.backend import (LaneBackend, LaneRequest,
                                      RescalableBackend)
from repro_torch.core.batch_progressive import ProgressiveEngine
from repro_torch.core.graph import FlatGraph, to_device
from repro_torch.core.pgs import DiverseResult
from repro_torch.serve import policies as P
from repro_torch.serve.cache import CacheEntry, SemanticResultCache
from repro_torch.serve.policies import ExpansionCostModel, make_policy
from repro_torch.serve.query import Query


class SchedulerSaturated(RuntimeError):
    """Admission queue is full — pump the scheduler (or defer) and retry.

    Raised by ``submit`` when ``len(pending) >= max_pending``. This is
    *backpressure*, not a verdict on the request: the same request is
    expected to succeed after ``pump()`` frees queue slots."""


class RequestShed(RuntimeError):
    """The scheduler's shed policy dropped this request at submit.

    Deliberately *not* a ``SchedulerSaturated``: saturation means "retry
    after pumping", shed means "never retry" — a retry loop catching
    ``SchedulerSaturated`` must not spin on a deterministically-shed
    request. Raised either by the legacy ``shed`` callback or by an
    admission policy returning ``SHED`` (e.g. ``slo_cost`` when a
    request's predicted service time alone exceeds its tenant's SLO
    budget)."""


class RequestDeferred(RuntimeError):
    """The admission policy declined this request *for now*.

    The middle ground between ``SchedulerSaturated`` (queue mechanics —
    retry immediately after a pump) and ``RequestShed`` (never retry):
    ``slo_cost`` defers a request whose predicted queue wait + service
    exceeds its SLO budget but whose service alone fits — once backlog
    drains, a retried submit is expected to admit. The request was *not*
    enqueued; ``total_deferred`` counts these decisions."""


@dataclasses.dataclass(eq=False)
class Request(LaneRequest):
    """One diverse-search request: a ``LaneRequest`` plus scheduler-side
    bookkeeping. Compares by identity (``eq=False``): two requests are
    never "the same request" just because their parameters match, and the
    policies' queue bookkeeping (``deque.remove``) relies on it.

    Fields added over ``LaneRequest`` (all scheduler-owned — backends never
    read them):

    * ``tenant`` — fairness/accounting label; admission policies (``drr``,
      ``slo_cost``) schedule *across* tenants, and ``latency_stats()``
      reports per-tenant percentiles. The default ``"default"`` keeps
      single-tenant callers unchanged.
    * ``rid`` — unique per-scheduler request id, assigned at submit (shed
      and deferred requests consume ids too, so traces stay unambiguous).
    * ``t_submit`` / ``t_admit`` / ``t_done`` — clock readings at submit,
      lane admission, and harvest (``None`` until reached).
    * ``lane`` — the backend lane that served it (``None`` until admitted;
      stays ``None`` for a cache hit, which never occupies one).
    * ``result`` — the harvested ``DiverseResult`` (``None`` until done).
    * ``cache_hit`` / ``cache_entry`` — set when the semantic result cache
      served this request at submit: the entry whose frontier was
      revalidated against this request's live query (kept so audits can
      independently re-run ``theorem2_recheck`` on served hits).
    * ``slo`` — the submitted ``Query``'s latency budget (seconds; None =
      best effort), carried for policies and shed callbacks to read.
    """
    tenant: str = "default"
    slo: float | None = None
    rid: int = -1
    t_submit: float = 0.0
    t_admit: float | None = None
    t_done: float | None = None
    lane: int | None = None
    result: DiverseResult | None = None
    cache_hit: bool = False
    cache_entry: CacheEntry | None = None

    @property
    def wait(self) -> float:
        """Submit-to-admission seconds (0.0 until admitted)."""
        return (self.t_admit or 0.0) - self.t_submit

    @property
    def service(self) -> float:
        """Admission-to-completion seconds (0.0 until done)."""
        return (self.t_done or 0.0) - (self.t_admit or 0.0)

    @property
    def latency(self) -> float:
        """Submit-to-completion seconds (0.0 until done)."""
        return (self.t_done or 0.0) - self.t_submit


@dataclasses.dataclass(eq=False)
class WriteTicket:
    """One admitted corpus write (``upsert`` or ``delete``).

    Writes share the scheduler's front door with reads: ``submit_write``
    enqueues, and the ticket is *applied* — delta append / bitmap flip on
    the backend's ``MutableIndex``, plus semantic-cache invalidation — at
    the top of the next ``pump()``, i.e. between backend rounds. In-flight
    lanes observe the write at harvest (contract 15's live merge), never
    mid-round. ``ids`` holds the assigned (upsert) or affected (delete) ids
    once applied; ``apply_writes()`` forces application without a pump.
    """
    op: str                          # "upsert" | "delete"
    payload: object                  # vectors [m, d] | ids
    wid: int = -1
    t_submit: float = 0.0
    t_applied: float | None = None
    ids: np.ndarray | None = None

    @property
    def applied(self) -> bool:
        return self.t_applied is not None


@dataclasses.dataclass
class ElasticPolicy:
    """When to move a rescalable backend between its prepared meshes.

    The scheduler samples queue depth at every pump boundary (the same
    between-rounds point the epoch swap uses — but the scale event is
    quiesce-free: in-flight lanes migrate, nothing drains). A signal must
    hold for ``sustain`` consecutive pumps before it fires, and after any
    scale event ``cooldown`` pumps pass before the next — both guards keep
    a bursty queue from thrashing the mesh.

    * grow: ``pending >= grow_depth`` (default: the backend's lane count —
      a full extra wave is waiting) sustained ``sustain`` pumps -> rescale
      to the next-larger prepared shard count.
    * shrink: ``pending <= shrink_depth`` sustained ``shrink_sustain``
      pumps -> next-smaller prepared count. In-flight lanes do NOT block a
      shrink; they straddle it and resume on the smaller mesh.
    """
    grow_depth: int | None = None      # None -> backend.num_lanes
    shrink_depth: int = 0
    sustain: int = 2
    shrink_sustain: int = 8
    cooldown: int = 8


def percentile(xs: list[float], p: float) -> float:
    """p-th percentile of a (possibly empty) sample — the summary helper
    shared with benchmarks so reported stats can't drift."""
    return float(np.percentile(np.asarray(xs), p)) if xs else 0.0


_pctl = percentile   # internal alias, kept for existing call sites


def jain_fairness(latencies: list[float]) -> float:
    """Jain's index over per-request latencies: 1.0 = perfectly even."""
    x = np.asarray(latencies, np.float64)
    if x.size == 0 or not np.any(x > 0):
        return 1.0
    return float((x.sum() ** 2) / (x.size * np.sum(x * x)))


class LaneScheduler:
    """Admission queue + lane recycling over any ``LaneBackend``.

    Construct with either a ``graph`` (builds the default single-host
    ``ProgressiveEngine`` over it on ``device``, ``cuda`` unless given; a
    graph elsewhere is moved there) or an explicit ``backend=`` (e.g. a
    mesh-sharded ``ShardedEngine``, which runs where it was built);
    everything above the backend — admission policies, backpressure, shed,
    stats — is identical.

    ``admission`` picks the batching regime:

    * ``"continuous"`` (default) — refill any freed lane before every step;
      a certified lane's slot goes to the next queued request immediately.
    * ``"lockstep"`` — refill only when *every* lane is free: the classic
      whole-batch regime (each wave waits for its straggler). Kept as the
      controlled baseline for the skewed-workload benchmark; results are
      identical either way, only latency/throughput differ.

    ``policy`` picks the admission-*order* policy draining the queue:
    ``"fifo"`` (default; submission order — bit-exactly the pre-policy
    scheduler), ``"drr"``, ``"slo_cost"``, or any
    ``serve.policies.AdmissionPolicy`` instance. ``cost_model`` optionally
    supplies a pre-calibrated (possibly frozen) ``ExpansionCostModel``; by
    default a fresh model is created and learns online from every
    harvested result regardless of policy, so ``latency_stats()`` always
    reports calibration.

    ``cache`` / ``cache_size`` enable the semantic result cache
    (``serve.cache.SemanticResultCache``; ``cache_size=N`` builds one over
    the backend's own corpus). ``submit`` probes it first: a near-hit whose
    certificate revalidates against the live query completes immediately —
    no lane, no queue slot — and every harvested certified result is
    offered back for admission. Contract 14: a hit is served only after
    its frontier was rescored against the live query and re-passed
    ``theorem2_recheck``; with distinct queries the cache never hits and
    the served results are bit-identical to an uncached scheduler.

    ``shed`` is an optional callback ``(request, scheduler) -> bool`` run at
    submit time; returning True drops the request (``RequestShed``). It
    predates the policy layer and stays supported — it runs *before* the
    policy's own decision, so existing SLO callbacks keep working verbatim
    (``slo_cost`` subsumes the common case with per-tenant budgets).
    """

    def __init__(self, graph: FlatGraph | None = None, num_lanes: int = 8, *,
                 backend: LaneBackend | None = None,
                 max_k: int = 16, default_ef: int = 40,
                 capacity0: int | None = None,
                 max_capacity: int | None = None,
                 max_pending: int | None = None,
                 max_iters: int = 64, max_expansions: int = 400_000,
                 max_signatures: int | None = 1024,
                 admission: str = "continuous",
                 policy: str | P.AdmissionPolicy = "fifo",
                 cost_model: ExpansionCostModel | None = None,
                 cache: SemanticResultCache | None = None,
                 cache_size: int = 0,
                 shed: Callable[[Request, "LaneScheduler"], bool] | None = None,
                 elastic: "ElasticPolicy | bool | None" = None,
                 prewarm: bool = True,
                 prewarm_capacity: int | None = None,
                 prewarm_ks: tuple = (), prewarm_widths: tuple = (),
                 history: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        if admission not in ("continuous", "lockstep"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if backend is None:
            if graph is None:
                raise ValueError("LaneScheduler needs a graph or a backend")
            backend = ProgressiveEngine(
                to_device(graph, resolve_device(device)), num_lanes, max_k=max_k, default_ef=default_ef,
                capacity0=capacity0, max_capacity=max_capacity,
                max_iters=max_iters, max_expansions=max_expansions,
                max_signatures=max_signatures)
        else:
            if graph is not None:
                raise ValueError("pass either graph or backend=, not both")
            if device is not None:
                raise ValueError("device= places a graph; a backend runs "
                                 "where it was built")
            # known limitation: a value explicitly passed that *equals* the
            # default (e.g. num_lanes=8) is indistinguishable from "not
            # passed" and is silently ignored; only non-default overrides
            # are caught here
            overridden = [name for name, (val, default) in dict(
                num_lanes=(num_lanes, 8), max_k=(max_k, 16),
                default_ef=(default_ef, 40), capacity0=(capacity0, None),
                max_capacity=(max_capacity, None), max_iters=(max_iters, 64),
                max_expansions=(max_expansions, 400_000),
                max_signatures=(max_signatures, 1024)).items()
                if val != default]
            if overridden:
                raise ValueError(
                    f"{overridden} are backend-construction parameters — "
                    "configure them on the backend, not the scheduler")
        self.backend = backend
        self.engine = backend   # legacy alias
        self.num_lanes = int(backend.num_lanes)
        # quantized backends get their own cost-model buckets: compressed
        # rounds have a different expansions/sec and round profile, so
        # pricing them with float traffic would skew fair scheduling
        self.backend_compressed = bool(getattr(backend, "compressed", False))
        self.admission = admission
        self.shed = shed
        self.cost_model = cost_model or ExpansionCostModel()
        self.policy = make_policy(policy).bind(self)
        if cache is not None and cache_size:
            raise ValueError("pass either cache= or cache_size=, not both")
        if cache is None and cache_size:
            cache = SemanticResultCache.for_backend(backend, cache_size)
        self.cache = cache
        if cache is not None and hasattr(backend, "record_candidates"):
            # certificate frontiers must reach harvest for cache admission
            backend.record_candidates = True
        self.max_pending = (max_pending if max_pending is not None
                            else 4 * self.num_lanes)
        self.clock = clock
        self.pending: collections.deque[Request] = collections.deque()
        self.inflight: dict[int, Request] = {}
        # bounded history: a long-running server must not grow without
        # bound; stats percentiles cover the retained window, counters
        # cover the lifetime
        self.completed: collections.deque[Request] = collections.deque(
            maxlen=history)
        self.total_completed = 0
        self.total_shed = 0
        self.total_deferred = 0
        #: lifetime per-tenant counters (mirroring the totals above).
        #: One entry per distinct tenant label, forever — like any labeled
        #: telemetry, keep tenant cardinality bounded (label by tenant,
        #: not by user/request); the policies' own queue state is
        #: proportional to tenants with *pending* work only
        self.tenant_completed: collections.Counter = collections.Counter()
        self.tenant_shed: collections.Counter = collections.Counter()
        self.tenant_deferred: collections.Counter = collections.Counter()
        self.total_cache_hits = 0
        self.tenant_cache_hits: collections.Counter = collections.Counter()
        self.write_queue: collections.deque[WriteTicket] = collections.deque()
        self.total_writes = 0
        self.total_writes_applied = 0
        self.total_cache_invalidations = 0
        self._next_rid = 0
        self._next_wid = 0
        self.steps = 0
        if elastic:
            if not isinstance(backend, RescalableBackend):
                raise ValueError(
                    "elastic= needs a rescalable backend (a ShardedEngine, "
                    "bare or under MutableBackend) with prepared targets — "
                    "the single-host engine has no mesh to scale")
            self.elastic = ElasticPolicy() if elastic is True else elastic
        else:
            self.elastic = None
        #: one dict per scale event: when, from/to shard counts, the
        #: migration pause (seconds the pump boundary spent inside
        #: ``backend.rescale``), and the queue state that triggered it
        self.scale_events: list[dict] = []
        self._elastic_hot = 0
        self._elastic_cold = 0
        self._elastic_cooldown = 0
        if prewarm:
            self.backend.prewarm(max_capacity=prewarm_capacity,
                                 ks=prewarm_ks, widths=prewarm_widths)

    # -- admission ----------------------------------------------------------
    def submit(self, q, k: int | None = None, eps: float | None = None,
               ef: int | None = None, method: str | None = None,
               max_K: int | None = None, tenant: str = "default",
               slo: float | None = None) -> Request:
        """Enqueue one request; returns its ``Request`` handle.

        ``q`` is either a ``serve.query.Query`` (the public parameter
        object — all other arguments must then be left at their defaults)
        or a raw query vector with ``(k, eps)`` the paper's per-request
        diversification parameters. ``ef`` defaults to the backend's
        ``default_ef``; ``method`` defaults to the backend's native method
        (``backend.methods[0]``); ``max_K`` caps the progressive candidate
        budget; ``tenant`` labels the request for fair scheduling and
        per-tenant stats; ``slo`` is an optional latency budget (seconds)
        for policies/shed callbacks. Text queries need an embedder and are
        resolved by ``DiverseVectorDB`` — the scheduler refuses them.

        Raises ``SchedulerSaturated`` on backpressure (retry after
        ``pump()``), ``RequestShed`` if the shed callback or the admission
        policy drops it (never retry), ``RequestDeferred`` if the policy
        declines it for now (retry once load drains), or ``ValueError`` for
        invalid parameters — rejected here, not at admission, because a bad
        request must never dequeue and then abort serving mid-pump.
        ``try_submit`` is the non-raising variant.
        """
        if isinstance(q, Query):
            if (k is not None or eps is not None or ef is not None
                    or method is not None or max_K is not None
                    or tenant != "default" or slo is not None):
                raise ValueError(
                    "submit(Query) takes no overrides — set the fields on "
                    "the Query itself (dataclasses.replace)")
            query = q
        else:
            if k is None or eps is None:
                raise TypeError("submit needs (q, k, eps) or a Query")
            query = Query(q, k=int(k), eps=float(eps), method=method,
                          tenant=tenant, slo=slo, ef=ef, max_K=max_K)
        method = query.method
        if method is None:
            method = self.backend.methods[0]
        if method not in self.backend.methods:
            raise ValueError(
                f"method {method!r} not served by this backend "
                f"(supported: {self.backend.methods})")
        k = int(query.k)
        if not 1 <= k <= self.backend.max_k:
            raise ValueError(
                f"k={k} outside [1, {self.backend.max_k}] (backend max_k)")
        req = None
        if self.cache is not None:
            # probe before backpressure: a revalidated hit completes here —
            # no lane, no queue slot — so even a saturated scheduler serves
            # duplicated traffic (the whole point of the cache)
            req = self._make_request(query, method)
            served = self._cache_probe(req)
            if served is not None:
                return served
        if len(self.pending) >= self.max_pending:
            raise SchedulerSaturated(
                f"{len(self.pending)} pending >= max_pending="
                f"{self.max_pending}; pump() or shed load")
        if req is None:
            req = self._make_request(query, method)
        tenant = req.tenant
        if self.shed is not None and self.shed(req, self):
            self.total_shed += 1
            self.tenant_shed[tenant] += 1
            raise RequestShed(f"request {req.rid} shed by SLO callback")
        decision = self.policy.on_submit(req)
        if decision == P.SHED:
            self.total_shed += 1
            self.tenant_shed[tenant] += 1
            raise RequestShed(
                f"request {req.rid} shed by {self.policy.name} policy")
        if decision == P.DEFER:
            self.total_deferred += 1
            self.tenant_deferred[tenant] += 1
            raise RequestDeferred(
                f"request {req.rid} deferred by {self.policy.name} policy "
                "(retry once backlog drains)")
        self.pending.append(req)
        self.policy.note_enqueued(req)
        return req

    def _make_request(self, query: Query, method: str) -> Request:
        req = Request(rid=self._next_rid, q=query.embedding(),
                      k=int(query.k), eps=float(query.eps),
                      ef=int(query.ef or self.backend.default_ef),
                      method=method, max_K=query.max_K, tenant=query.tenant,
                      slo=query.slo, t_submit=self.clock())
        self._next_rid += 1   # dropped requests keep their rid (unique traces)
        return req

    def _cache_probe(self, req: Request) -> Request | None:
        """Serve ``req`` from the semantic result cache if a near-hit
        revalidates against its live query; None falls through to the
        normal admission path. Hit or miss is folded into the cost model's
        per-bucket hit probability either way."""
        hit = self.cache.lookup(req.q, req.k, req.eps, req.method)
        self.cost_model.observe_cache(req.k, req.eps, req.method,
                                      hit=hit is not None,
                                      compressed=self.backend_compressed)
        if hit is None:
            return None
        result, entry = hit
        now = self.clock()
        req.t_admit = now
        req.t_done = now
        req.result = result
        req.cache_hit = True
        req.cache_entry = entry
        self.completed.append(req)
        self.total_completed += 1
        self.tenant_completed[req.tenant] += 1
        self.total_cache_hits += 1
        self.tenant_cache_hits[req.tenant] += 1
        return req

    def try_submit(self, q, k: int, eps: float, **kw) -> Request | None:
        """``submit`` returning ``None`` instead of raising, for all three
        drop reasons — saturation, shed, and deferral. Callers that need to
        tell them apart compare ``total_shed`` / ``total_deferred`` across
        the call (a saturated submit moves neither counter); parameter
        ``ValueError``s still raise."""
        try:
            return self.submit(q, k, eps, **kw)
        except (SchedulerSaturated, RequestShed, RequestDeferred):
            return None

    # -- write admission -----------------------------------------------------
    def submit_write(self, op: str, payload) -> WriteTicket:
        """Enqueue one corpus write (``op`` = ``"upsert"`` with ``[m, d]``
        vectors, or ``"delete"`` with ids); returns its ``WriteTicket``.

        Writes are *admitted* here and *applied* at the next pump boundary
        (or an explicit ``apply_writes()``) — between backend rounds, never
        mid-round — so reads and writes share one front door and one
        ordering. Requires a write-capable backend (``MutableBackend`` /
        ``DiverseVectorDB``)."""
        if getattr(self.backend, "mutable_index", None) is None:
            raise TypeError(
                "this backend has no write path — serve through "
                "DiverseVectorDB (or wrap the engine in a MutableBackend)")
        if op not in ("upsert", "delete"):
            raise ValueError(f"unknown write op {op!r}")
        ticket = WriteTicket(op=op, payload=payload, wid=self._next_wid,
                             t_submit=self.clock())
        self._next_wid += 1
        self.write_queue.append(ticket)
        self.total_writes += 1
        return ticket

    def apply_writes(self) -> list[WriteTicket]:
        """Apply every queued write to the backend's ``MutableIndex`` (in
        admission order) and invalidate intersecting cache entries; returns
        the applied tickets. Runs automatically at the top of ``pump()``."""
        applied: list[WriteTicket] = []
        index = self.backend.mutable_index
        while self.write_queue:
            t = self.write_queue.popleft()
            if t.op == "upsert":
                t.ids = index.upsert(t.payload)
            else:
                t.ids = np.asarray(t.payload, np.int64).reshape(-1)
                index.delete(t.ids)
            t.t_applied = self.clock()
            if self.cache is not None:
                self.total_cache_invalidations += self.cache.invalidate(t.ids)
            self.total_writes_applied += 1
            applied.append(t)
        return applied

    def _refill(self) -> None:
        if self.admission == "lockstep" and self.inflight:
            return  # whole-batch regime: wait for the wave's straggler
        for lane in self.backend.free_lanes():
            req = self.policy.pop_next()
            if req is None:
                break
            self.backend.admit(int(lane), req)
            req.t_admit = self.clock()
            req.lane = int(lane)
            self.inflight[int(lane)] = req

    def _maybe_rescale(self) -> None:
        """Elastic scale trigger, run at the pump boundary (between backend
        rounds — every lane is paused-but-resumable there, which is what
        makes the quiesce-free migration legal)."""
        pol = self.elastic
        if pol is None:
            return
        if self._elastic_cooldown > 0:
            self._elastic_cooldown -= 1
            return
        depth = len(self.pending)
        grow_depth = (pol.grow_depth if pol.grow_depth is not None
                      else self.num_lanes)
        if depth >= grow_depth:
            self._elastic_hot += 1
            self._elastic_cold = 0
        elif depth <= pol.shrink_depth:
            self._elastic_cold += 1
            self._elastic_hot = 0
        else:
            self._elastic_hot = self._elastic_cold = 0
        cur = int(self.backend.num_shards)
        options = self.backend.rescale_options()
        target = None
        if self._elastic_hot >= pol.sustain:
            bigger = [p for p in options if p > cur]
            target = min(bigger) if bigger else None
        elif self._elastic_cold >= pol.shrink_sustain and not self.inflight:
            # shrink only when fully idle: targets prepared with fewer
            # lanes then always get their clean lane shrink too (the
            # engine never drops an occupied lane)
            smaller = [p for p in options if p < cur]
            target = max(smaller) if smaller else None
        if target is None:
            return
        t0 = self.clock()
        if self.backend.rescale(target):
            self.scale_events.append(dict(
                t=t0, from_shards=cur, to_shards=int(target),
                pause_s=self.clock() - t0, pending=depth,
                inflight=len(self.inflight)))
            # serving capacity may follow the mesh (lane-scaled targets)
            self.num_lanes = int(self.backend.num_lanes)
        self._elastic_hot = self._elastic_cold = 0
        self._elastic_cooldown = pol.cooldown

    # -- serving loop -------------------------------------------------------
    def pump(self) -> list[Request]:
        """Refill freed lanes (in policy order), advance the backend one
        step, harvest and recycle finished lanes; returns the requests that
        completed. Every harvested result's real ``SearchStats`` counters
        (expansions, rounds) and measured service time are folded into the
        cost model before the next refill, so policy predictions track the
        live workload. Queued writes are applied first — the pump boundary
        is the write boundary (contract 15) and, under ``elastic=``, the
        scale boundary (contract 16: in-flight lanes migrate, nothing
        drains)."""
        if self.write_queue:
            self.apply_writes()
        if self.elastic is not None:
            self._maybe_rescale()
        self._refill()
        done: list[Request] = []
        if self.backend.active_count():
            self.steps += 1
            self.backend.step()
        for lane, result in self.backend.harvest():
            req = self.inflight.pop(lane)
            req.result = result
            req.t_done = self.clock()
            if self.cache is not None and result.stats.certified:
                rec = getattr(self.backend, "last_candidates",
                              [None] * self.num_lanes)[lane]
                if rec is not None:
                    cand_ids, cand_scores, *rest = rec
                    self.cache.admit_request(
                        req.q, req.k, req.eps, req.method, result,
                        cand_ids, cand_scores,
                        slack=rest[0] if rest else None)
            self.backend.recycle(lane)
            self.completed.append(req)
            self.total_completed += 1
            self.tenant_completed[req.tenant] += 1
            self.cost_model.observe(
                req.k, req.eps, req.method,
                expansions=result.stats.expansions,
                rounds=result.stats.search_calls,
                service=req.service,
                compressed=self.backend_compressed)
            self.policy.on_complete(req)
            done.append(req)
        return done

    def drain(self) -> list[Request]:
        """Pump until the queues (read and write) and all lanes are empty."""
        out: list[Request] = []
        while self.pending or self.inflight or self.write_queue:
            out.extend(self.pump())
            self._refill()
        return out

    def run(self, qs, ks, epss, efs=None, method: str | None = None,
            tenants=None) -> list[DiverseResult | None]:
        """Serve a closed batch of requests; results in submission order.

        Per-request parameters (``ks``, ``epss``, ``efs``, ``tenants``) may
        be scalars or per-request sequences. Oversubmission is handled by
        pumping whenever the queue saturates, and a policy-deferred request
        is retried after a pump (deferral is load-dependent, so draining
        backlog un-defers it); a request dropped by the shed policy yields
        ``None`` in its slot (it is *not* retried — a deterministic policy
        would shed it again forever).
        """
        qs = np.asarray(qs, np.float32)
        B = qs.shape[0]
        ks = np.broadcast_to(np.asarray(ks), (B,))
        epss = np.broadcast_to(np.asarray(epss, np.float64), (B,))
        efs = np.broadcast_to(
            np.asarray(efs if efs is not None else self.backend.default_ef),
            (B,))
        tenants = np.broadcast_to(
            np.asarray(tenants if tenants is not None else "default"), (B,))
        reqs: list[Request | None] = []
        for i in range(B):
            while True:
                try:
                    reqs.append(self.submit(qs[i], int(ks[i]),
                                            float(epss[i]), ef=int(efs[i]),
                                            method=method,
                                            tenant=str(tenants[i])))
                    break
                except RequestShed:
                    reqs.append(None)
                    break
                except (SchedulerSaturated, RequestDeferred):
                    self.pump()   # free queue slots / drain backlog, retry
        self.drain()
        return [r.result if r is not None else None for r in reqs]

    # -- reporting ----------------------------------------------------------
    def latency_stats(self) -> dict:
        """Serving stats snapshot.

        Percentiles and throughput cover the retained ``history`` window of
        completed requests; ``completed`` / ``shed`` / ``deferred`` count
        the scheduler's lifetime. Keys:

        * ``completed`` / ``shed`` — lifetime request counts: finished,
          dropped-never-retry. ``deferred`` — lifetime count of *defer
          decisions* (a request resubmitted after deferral and deferred
          again counts each time).
        * ``pending`` / ``inflight`` — current queue depth and occupied
          lanes; ``steps`` — lifetime backend steps.
        * ``p50_latency`` / ``p99_latency`` — submit→done seconds over the
          window; ``p50_wait`` / ``p99_wait`` — submit→admit;
          ``p50_service`` / ``p99_service`` — admit→done.
        * ``fairness`` — Jain's index over the window's total latencies
          (all tenants pooled); ``tenant_fairness`` — Jain's index over
          *per-tenant mean* latencies (1.0 = tenants see equal means).
        * ``tenants`` — per-tenant sub-dicts (window percentiles +
          lifetime counters): ``completed``, ``shed``, ``deferred``,
          ``p50_latency``, ``p99_latency``, ``p99_wait``, ``mean_latency``,
          ``fairness`` (within-tenant Jain).
        * ``throughput`` — window completions / window span (req/s).
        * ``certified_frac`` — fraction of window results whose Theorem-2
          certificate fired.
        * ``policy`` — the admission policy name;
          ``cost_calibration_error`` — the cost model's EWMA relative
          expansion-prediction error (see
          ``ExpansionCostModel.calibration_error``).
        * ``cache_hits`` — lifetime requests served by the semantic result
          cache (a subset of ``completed``; hits are real completions and
          their — tiny — latencies are in the pooled percentiles);
          ``cache_hit_rate`` — lifetime hits / cache probes;
          ``hit_p50_latency`` / ``hit_p99_latency`` — percentiles over the
          window's *hit* latencies only (probe + revalidation time);
          ``cache`` — the cache's own counters (``SemanticResultCache
          .stats()``), or None when serving uncached.
        * ``writes`` / ``writes_applied`` / ``writes_pending`` — lifetime
          write tickets admitted / applied, and the current write-queue
          depth; ``cache_invalidations`` — lifetime cache entries evicted
          because a write touched their stored frontier.
        * ``signatures`` / ``unplanned_signatures`` — backend shape-class
          signatures seen / seen after a freeze.
        * ``shards`` — the rescalable backend's current mesh shard count
          (None on a single-host backend); ``scale_events`` — lifetime
          elastic scale events (grow + shrink; the per-event records,
          including migration pause, are in ``scale_events`` the list
          attribute).
        * ``compressed`` / ``bytes_per_vector`` — the backend's corpus
          representation: whether rounds score a quantized corpus, and the
          stored bytes per vector (the memory-scaling stat).
        """
        reqs = list(self.completed)
        lats = [r.latency for r in reqs]
        hit_lats = [r.latency for r in reqs if r.cache_hit]
        waits = [r.wait for r in reqs]
        svcs = [r.service for r in reqs]
        span = (max(r.t_done for r in reqs) - min(r.t_submit for r in reqs)
                if reqs else 0.0)
        by_tenant: dict[str, list[Request]] = {}
        for r in reqs:
            by_tenant.setdefault(r.tenant, []).append(r)
        tenants = {}
        for name in sorted(set(by_tenant) | set(self.tenant_completed)
                           | set(self.tenant_shed)
                           | set(self.tenant_deferred)):
            trs = by_tenant.get(name, [])
            tl = [r.latency for r in trs]
            tenants[name] = dict(
                completed=self.tenant_completed.get(name, 0),
                shed=self.tenant_shed.get(name, 0),
                deferred=self.tenant_deferred.get(name, 0),
                cache_hits=self.tenant_cache_hits.get(name, 0),
                p50_latency=_pctl(tl, 50), p99_latency=_pctl(tl, 99),
                p99_wait=_pctl([r.wait for r in trs], 99),
                mean_latency=float(np.mean(tl)) if tl else 0.0,
                fairness=jain_fairness(tl),
            )
        # cross-tenant fairness over tenants *in the window* only: a tenant
        # whose completions aged out of `history` would otherwise inject a
        # spurious 0.0 mean and report unfairness on an idle tenant
        tenant_means = [t["mean_latency"] for name, t in tenants.items()
                       if by_tenant.get(name)]
        return dict(
            completed=self.total_completed,
            shed=self.total_shed,
            deferred=self.total_deferred,
            pending=len(self.pending),
            inflight=len(self.inflight),
            steps=self.steps,
            p50_latency=_pctl(lats, 50), p99_latency=_pctl(lats, 99),
            p50_wait=_pctl(waits, 50), p99_wait=_pctl(waits, 99),
            p50_service=_pctl(svcs, 50), p99_service=_pctl(svcs, 99),
            fairness=jain_fairness(lats),
            tenant_fairness=jain_fairness(tenant_means),
            tenants=tenants,
            throughput=len(reqs) / span if span > 0 else 0.0,
            certified_frac=(float(np.mean([r.result.stats.certified
                                           for r in reqs])) if reqs else 0.0),
            policy=self.policy.name,
            cost_calibration_error=self.cost_model.calibration_error(),
            cache_hits=self.total_cache_hits,
            cache_hit_rate=(self.total_cache_hits / self.cache.probes
                            if self.cache is not None and self.cache.probes
                            else 0.0),
            hit_p50_latency=_pctl(hit_lats, 50),
            hit_p99_latency=_pctl(hit_lats, 99),
            cache=self.cache.stats() if self.cache is not None else None,
            writes=self.total_writes,
            writes_applied=self.total_writes_applied,
            writes_pending=len(self.write_queue),
            cache_invalidations=self.total_cache_invalidations,
            compressed=self.backend_compressed,
            bytes_per_vector=float(
                getattr(self.backend, "bytes_per_vector", 0.0)),
            signatures=len(self.backend.signature_log),
            unplanned_signatures=len(self.backend.signature_log.unplanned),
            shards=(int(self.backend.num_shards)
                    if isinstance(self.backend, RescalableBackend)
                    else None),
            scale_events=len(self.scale_events),
        )
