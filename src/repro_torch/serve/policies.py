"""Cost-aware admission policies for the lane scheduler (port of
``repro.serve.policies``: the same decisions, and the same JSON from
``ExpansionCostModel.save``).

The paper's progressive framework makes per-request cost structurally
skewed: latency grows sharply with ``k`` and with the diversification level
``eps`` (denser G^eps graphs expand far more candidates per round before
Theorem 2 certifies). A FIFO queue therefore lets one tenant's heavy-eps
traffic starve everyone else, and a boolean shed callback can only drop
load, not schedule it. This module is the scheduling-policy layer that
replaces both with decisions driven by *measured search cost*:

* ``ExpansionCostModel`` — an online per-``(k, eps, method)`` cost model
  learning expansions-per-round and rounds-to-finish from the real
  ``SearchStats`` counters every harvested result carries (EWMA per bucket;
  ``k`` is power-of-two bucketed, ``eps`` is banded). Cold buckets fall
  back to a static Theorem-1 prior, so estimates exist before any traffic.
  A global seconds-per-expansion EWMA converts predicted expansions into
  predicted service time once at least one request has been timed.
* ``FifoPolicy`` — the scheduler's historical behavior, bit-exactly: the
  admission queue is served in submission order and nothing is ever shed
  or deferred by the policy (the legacy ``shed`` callback still applies).
* ``DrrPolicy`` — deficit round-robin over the per-request ``tenant``
  field, with the deficit charged in *predicted expansions* rather than
  request count: tenants get equal shares of search work, so a tenant
  flooding cheap requests cannot starve a sparse tenant's occasional
  heavy-eps request.
* ``SloCostPolicy`` — admission control from predicted service time vs a
  per-tenant SLO budget: requests that cannot meet their budget even on an
  idle system are shed outright, requests that merely face too much
  backlog are deferred (the caller may retry once load drains), and the
  queue is drained earliest-deadline-first.

Determinism contract (pinned against the reference by
``tests/test_torch_scheduler.py``): every policy
decision is a pure function of the submit/harvest sequence, the scheduler's
injectable clock, and the cost model's state. With a fixed request trace
and a deterministic clock, the admission order is reproducible run-to-run
and — with a frozen cost model — identical over any ``LaneBackend``
(admission order is scheduler-level state; per-request *results* never
depend on it, by the backends' lane-separability contracts).
"""
from __future__ import annotations

import collections
import json
import math

from repro_torch.core.bucketing import next_pow2

#: decisions a policy may return from ``on_submit``
ADMIT, SHED, DEFER = "admit", "shed", "defer"


def theorem1_prior(k: int, K0: int = 32, prior_degree: float = 3.0,
                   round_cost: float = 4.0) -> tuple[float, float]:
    """Static cold-start prior ``(expansions_per_round, rounds)``.

    Theorem 1 bounds the sufficient candidate count by the degrees of
    G^eps: K >= sum over the k-1 highest-degree candidates of (phi_v + 1),
    plus one. With an assumed mean G^eps degree ``prior_degree`` that gives
    a prior final budget ``K ~= (k - 1) * (prior_degree + 1) + 1``; the
    progressive ladder doubles from ``K0``, so the prior round count is the
    number of doublings to reach it, and the prior per-round expansion cost
    is ``round_cost`` beam steps per candidate. The prior is deliberately
    coarse — its only job is to give cold buckets a finite, k-monotone
    estimate so policies can order requests before any traffic; the
    eps-specific cost is learned, not assumed (eps scales are
    metric-dependent and not comparable across corpora).
    """
    K_prior = max((k - 1) * (prior_degree + 1.0) + 1.0, float(K0))
    rounds = 1.0 + max(0.0, math.ceil(math.log2(K_prior / K0)))
    return round_cost * K_prior, rounds


class ExpansionCostModel:
    """Online per-``(k, eps, method)`` cost model over harvested SearchStats.

    Buckets are ``(next_pow2(k), eps_band, method)``: power-of-two ``k``
    bucketing mirrors the engines' own budget ladders (requests sharing a
    pow2 rung share compile signatures *and* cost character), and ``eps``
    banding defaults to the exact (rounded) eps value — serving workloads
    use a handful of calibrated diversification levels, so each level gets
    its own band; pass ``eps_bands`` (sorted band edges) to coarsen.

    Per bucket the model keeps EWMAs of expansions-per-round and
    rounds-to-finish (updated from ``SearchStats.expansions`` /
    ``search_calls`` — the *real* counters the backends report); a global
    EWMA of seconds-per-expansion turns predicted expansions into predicted
    service seconds. Cold buckets fall back to :func:`theorem1_prior`, so
    ``predict_expansions`` is total before the first observation; predicted
    *service* is 0.0 until one timed request has been observed (no
    defensible static prior exists for wall-clock cost).

    ``freeze()`` stops all updates — deploy a calibrated model read-only,
    or pin cross-backend admission-order parity in tests.
    """

    def __init__(self, *, K0: int = 32, prior_degree: float = 3.0,
                 prior_round_cost: float = 4.0, alpha: float = 0.25,
                 eps_bands: tuple = (), max_buckets: int = 4096):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha={alpha} outside (0, 1]")
        self.K0 = int(K0)
        self.prior_degree = float(prior_degree)
        self.prior_round_cost = float(prior_round_cost)
        self.alpha = float(alpha)
        self.eps_bands = tuple(float(e) for e in eps_bands)
        self.max_buckets = int(max_buckets)
        #: bucket -> [ewma_expansions_per_round, ewma_rounds, count]
        self._buckets: dict[tuple, list] = {}
        #: bucket -> [ewma_hit_probability, count] — learned from the
        #: semantic result cache's probe outcomes (observe_cache)
        self._hit: dict[tuple, list] = {}
        self._sec_per_exp = 0.0
        self._sec_obs = 0
        self._calib_err = 0.0
        self._calib_obs = 0
        self.frozen = False

    # -- bucketing -----------------------------------------------------------
    def _eps_band(self, eps: float):
        if self.eps_bands:
            lo = 0
            for i, edge in enumerate(self.eps_bands):
                if eps >= edge:
                    lo = i + 1
            return lo
        return round(float(eps), 6)

    def bucket(self, k: int, eps: float, method: str,
               compressed: bool = False) -> tuple:
        """The model's bucket key for a request shape.

        ``compressed`` marks requests served against a quantized corpus
        (``LaneBackend.compressed``): quantized rounds score int8/PQ codes
        and pay an exact-rerank stage, so their expansions-per-second and
        round counts are not exchangeable with float traffic — pricing them
        in the same bucket would mis-bill both tenants. Cold compressed
        buckets still fall back to :func:`theorem1_prior` (Theorem 1 bounds
        the *candidate count*, which quantization does not change — contract
        13: quantization is a memory knob, never a certificate knob).
        """
        return (next_pow2(max(int(k), 1)), self._eps_band(eps), str(method),
                bool(compressed))

    # -- prediction ----------------------------------------------------------
    def predict_rounds(self, k: int, eps: float, method: str,
                       compressed: bool = False) -> float:
        cell = self._buckets.get(self.bucket(k, eps, method, compressed))
        if cell is not None:
            return cell[1]
        return theorem1_prior(int(k), self.K0, self.prior_degree,
                              self.prior_round_cost)[1]

    def predict_expansions(self, k: int, eps: float, method: str,
                           compressed: bool = False, *,
                           offered: bool = False) -> float:
        """Predicted total expansions for one request of this shape.

        ``offered=True`` prices an *offered* request rather than an
        admitted one: the prediction is discounted by the bucket's learned
        cache-hit probability (a hit costs the system no expansions), so a
        tenant whose traffic the semantic cache absorbs is billed only for
        the work its stream actually induces. With no cache observations
        the hit rate is 0.0 and both modes agree exactly.
        """
        cell = self._buckets.get(self.bucket(k, eps, method, compressed))
        if cell is not None:
            exp = max(cell[0] * cell[1], 1.0)
        else:
            epr, rounds = theorem1_prior(int(k), self.K0, self.prior_degree,
                                         self.prior_round_cost)
            exp = max(epr * rounds, 1.0)
        if offered:
            exp *= 1.0 - self.predict_hit_rate(k, eps, method, compressed)
        return exp

    def predict_hit_rate(self, k: int, eps: float, method: str,
                         compressed: bool = False) -> float:
        """Learned semantic-cache hit probability for this bucket (EWMA of
        probe outcomes; 0.0 until the first ``observe_cache``)."""
        cell = self._hit.get(self.bucket(k, eps, method, compressed))
        return cell[0] if cell is not None else 0.0

    @property
    def sec_per_expansion(self) -> float:
        """Learned seconds per expansion (0.0 before any timed request)."""
        return self._sec_per_exp

    def predict_service(self, k: int, eps: float, method: str,
                        compressed: bool = False, *,
                        offered: bool = False) -> float:
        """Predicted service seconds; 0.0 until a timed request was seen.
        ``offered=True`` applies the cache-hit discount (see
        ``predict_expansions``)."""
        return (self.predict_expansions(k, eps, method, compressed,
                                        offered=offered)
                * self._sec_per_exp)

    # -- updates -------------------------------------------------------------
    def observe(self, k: int, eps: float, method: str, *,
                expansions: int, rounds: int,
                service: float | None = None,
                compressed: bool = False) -> None:
        """Fold one harvested request into the model.

        ``expansions``/``rounds`` are the result's real ``SearchStats``
        counters (``expansions`` / ``search_calls``); ``service`` is the
        measured admit-to-done wall time (optional — untimed observations
        still update the expansion EWMAs). The pre-update prediction error
        feeds the calibration EWMA, so ``calibration_error()`` reflects how
        well the model *would have* predicted each request before seeing it.
        No-op when frozen.
        """
        if self.frozen:
            return
        actual = float(max(int(expansions), 1))
        rel_err = abs(self.predict_expansions(k, eps, method, compressed)
                      - actual) / actual
        self._calib_obs += 1
        a = self.alpha if self._calib_obs > 1 else 1.0
        self._calib_err += a * (rel_err - self._calib_err)
        r = float(max(int(rounds), 1))
        epr = actual / r
        key = self.bucket(k, eps, method, compressed)
        cell = self._buckets.get(key)
        if cell is None:
            # bounded model state for long-running servers: past the cap,
            # stop adding bands (existing buckets and the prior still
            # serve) — but the global time-rate EWMA below must keep
            # tracking drift regardless
            if len(self._buckets) < self.max_buckets:
                self._buckets[key] = [epr, r, 1]
        else:
            cell[0] += self.alpha * (epr - cell[0])
            cell[1] += self.alpha * (r - cell[1])
            cell[2] += 1
        if service is not None and service > 0:
            self._sec_obs += 1
            a = self.alpha if self._sec_obs > 1 else 1.0
            self._sec_per_exp += a * (service / actual - self._sec_per_exp)

    def observe_cache(self, k: int, eps: float, method: str, *,
                      hit: bool, compressed: bool = False) -> None:
        """Fold one semantic-cache probe outcome into the bucket's hit
        probability EWMA (the scheduler calls this on every probed submit,
        hit or miss). No-op when frozen."""
        if self.frozen:
            return
        key = self.bucket(k, eps, method, compressed)
        cell = self._hit.get(key)
        x = 1.0 if hit else 0.0
        if cell is None:
            if (len(self._buckets) + len(self._hit)) < 2 * self.max_buckets:
                self._hit[key] = [x, 1]
        else:
            cell[0] += self.alpha * (x - cell[0])
            cell[1] += 1

    def freeze(self) -> "ExpansionCostModel":
        """Stop updating (predictions keep working); returns self."""
        self.frozen = True
        return self

    # -- persistence ---------------------------------------------------------
    _STATE_VERSION = 1

    def save(self, path) -> None:
        """Write the model's full state as JSON — config, every bucket EWMA
        (cost and cache-hit), the time-rate and calibration EWMAs, and the
        frozen flag — so a restarted server resumes with a warm model
        (``load`` round-trips it exactly; bucket keys serialize as
        ``[k_pow2, eps_band, method, compressed]`` lists)."""
        doc = dict(
            version=self._STATE_VERSION,
            K0=self.K0, prior_degree=self.prior_degree,
            prior_round_cost=self.prior_round_cost, alpha=self.alpha,
            eps_bands=list(self.eps_bands), max_buckets=self.max_buckets,
            buckets=[[list(k), list(v)] for k, v in self._buckets.items()],
            hit_buckets=[[list(k), list(v)] for k, v in self._hit.items()],
            sec_per_exp=self._sec_per_exp, sec_obs=self._sec_obs,
            calib_err=self._calib_err, calib_obs=self._calib_obs,
            frozen=self.frozen,
        )
        with open(path, "w") as f:
            json.dump(doc, f)

    @classmethod
    def load(cls, path) -> "ExpansionCostModel":
        """Reconstruct a model from ``save`` output, bit-exactly (floats
        round-trip through JSON's shortest-repr encoding)."""
        with open(path) as f:
            doc = json.load(f)
        if doc.get("version") != cls._STATE_VERSION:
            raise ValueError(
                f"cost-model state version {doc.get('version')!r} != "
                f"{cls._STATE_VERSION} (refusing a half-compatible load)")
        m = cls(K0=doc["K0"], prior_degree=doc["prior_degree"],
                prior_round_cost=doc["prior_round_cost"],
                alpha=doc["alpha"], eps_bands=tuple(doc["eps_bands"]),
                max_buckets=doc["max_buckets"])
        m._buckets = {tuple(k): list(v) for k, v in doc["buckets"]}
        m._hit = {tuple(k): list(v) for k, v in doc["hit_buckets"]}
        m._sec_per_exp = doc["sec_per_exp"]
        m._sec_obs = doc["sec_obs"]
        m._calib_err = doc["calib_err"]
        m._calib_obs = doc["calib_obs"]
        m.frozen = doc["frozen"]
        return m

    # -- reporting -----------------------------------------------------------
    def calibration_error(self) -> float:
        """EWMA of the relative |predicted - actual| expansion error,
        each prediction taken *before* its observation was folded in
        (0.0 until the first observation)."""
        return self._calib_err if self._calib_obs else 0.0

    def stats(self) -> dict:
        """Model summary: bucket count, observation count, calibration."""
        return dict(
            buckets=len(self._buckets),
            observations=sum(c[2] for c in self._buckets.values()),
            hit_buckets=len(self._hit),
            cache_observations=sum(c[1] for c in self._hit.values()),
            calibration_error=self.calibration_error(),
            sec_per_expansion=self._sec_per_exp,
            frozen=self.frozen,
        )


class AdmissionPolicy:
    """Base class for pluggable admission policies.

    A policy is bound to exactly one ``LaneScheduler`` (``bind``); the
    scheduler consults it at two points:

    * ``on_submit(req)`` — returns ``ADMIT`` (enqueue), ``SHED`` (drop,
      never retry) or ``DEFER`` (drop, caller may retry once load drains).
      Runs *after* the legacy ``shed`` callback, which stays supported.
    * ``pop_next()`` — called once per free lane per pump: remove and
      return the next pending request to admit (or None to leave lanes
      idle). The scheduler's ``pending`` deque is the source of truth; a
      policy that keeps its own structures must keep them consistent via
      ``note_enqueued``.

    Subclasses must be deterministic given the submit/pop/complete sequence
    and the scheduler clock (see the module docstring).
    """

    name = "base"

    def __init__(self):
        self.sched = None

    def bind(self, sched) -> "AdmissionPolicy":
        if self.sched is not None and self.sched is not sched:
            raise RuntimeError(
                f"policy {self.name!r} is already bound to another "
                "scheduler; policies hold per-scheduler queue state")
        self.sched = sched
        return self

    @property
    def model(self) -> ExpansionCostModel:
        return self.sched.cost_model

    @property
    def compressed(self) -> bool:
        """Whether the bound scheduler's backend scores a quantized corpus
        (``LaneBackend.compressed``) — forwarded into every cost-model
        lookup so quantized traffic is priced in its own buckets."""
        return bool(getattr(self.sched, "backend_compressed", False))

    def on_submit(self, req) -> str:
        return ADMIT

    def note_enqueued(self, req) -> None:
        """Called after the scheduler appended an admitted ``req`` to its
        pending deque."""

    def pop_next(self):
        """Remove and return the next request to admit, or None."""
        raise NotImplementedError

    def on_complete(self, req) -> None:
        """Called after a request finished (the scheduler has already fed
        the cost model); policies rarely need it."""


class FifoPolicy(AdmissionPolicy):
    """Submission-order admission — the scheduler's historical behavior,
    bit-exactly."""

    name = "fifo"

    def pop_next(self):
        sched = self.sched
        return sched.pending.popleft() if sched.pending else None


class DrrPolicy(AdmissionPolicy):
    """Deficit round-robin over tenants, charged in predicted expansions.

    Classic DRR (Shreedhar & Varghese) with the packet length replaced by
    the cost model's predicted expansion count for the head request: each
    active tenant holds a deficit counter; a visit adds ``quantum``
    (expansions) and serves the tenant's queue head while the deficit
    covers its predicted cost; an emptied tenant leaves the active list
    and forfeits its deficit (no banking). Equal *work* shares mean a
    tenant flooding cheap low-eps requests cannot starve another tenant's
    sparse heavy-eps traffic — the failure mode FIFO has on exactly the
    skewed mixes the paper's cost asymmetry produces.

    ``quantum`` trades fairness granularity against scheduling overhead
    (any positive value is work-conserving; smaller values interleave
    tenants at finer expansion granularity). ``quanta`` overrides the
    quantum per tenant — classic weighted DRR: a tenant with twice the
    quantum earns deficit twice as fast and receives twice the share of
    served search work under contention (tenants not listed keep the
    uniform default).

    Head costs are priced at the *offered* rate
    (``predict_expansions(..., offered=True)``): once the semantic result
    cache has absorbed part of a tenant's stream, that tenant's remaining
    misses are billed net of the hit probability, so its fair share is of
    offered traffic, not of cache-miss traffic — the cache's savings are
    not charged to the tenant that earned them. With no cache (or no
    observations yet) the discount is exactly zero and the pre-cache
    admission order is reproduced bit-for-bit.
    """

    name = "drr"

    def __init__(self, quantum: float = 256.0,
                 quanta: dict | None = None):
        super().__init__()
        if quantum <= 0:
            raise ValueError(f"quantum={quantum} must be positive")
        self.quantum = float(quantum)
        self.quanta = {str(t): float(q) for t, q in (quanta or {}).items()}
        for t, q in self.quanta.items():
            if q <= 0:
                raise ValueError(f"quanta[{t!r}]={q} must be positive")
        self._queues: dict[str, collections.deque] = {}
        self._active: list[str] = []
        self._deficit: dict[str, float] = {}
        self._ptr = 0
        self._fresh_visit = True

    def quantum_for(self, tenant: str) -> float:
        return self.quanta.get(tenant, self.quantum)

    def note_enqueued(self, req) -> None:
        q = self._queues.setdefault(req.tenant, collections.deque())
        if not q and req.tenant not in self._active:
            self._active.append(req.tenant)
            self._deficit[req.tenant] = 0.0
        q.append(req)

    def _deactivate(self, tenant: str) -> None:
        # an emptied tenant forfeits its deficit AND its dict entries —
        # policy state stays proportional to tenants with queued work, not
        # to every label ever seen (high-cardinality tenants must not leak)
        i = self._active.index(tenant)
        del self._active[i]
        del self._deficit[tenant]
        del self._queues[tenant]
        if self._active:
            if i < self._ptr:
                self._ptr -= 1
            self._ptr %= len(self._active)
        else:
            self._ptr = 0
        self._fresh_visit = True

    def pop_next(self):
        sched = self.sched
        if not sched.pending:
            return None
        # terminates: every full cycle adds `quantum` to each surviving
        # tenant's deficit, so some head cost is covered after at most
        # ceil(max_cost / quantum) cycles (quantum > 0 by construction)
        while True:
            if not self._active:
                # defensive (note_enqueued tracks every append, so pending
                # and the tenant queues can only disagree if a caller
                # mutated `pending` directly): drain work-conserving FIFO
                # rather than idle a lane forever
                return sched.pending.popleft()
            tenant = self._active[self._ptr]
            queue = self._queues[tenant]
            if not queue:
                self._deactivate(tenant)
                continue
            if self._fresh_visit:
                self._deficit[tenant] += self.quantum_for(tenant)
                self._fresh_visit = False
            head = queue[0]
            cost = self.model.predict_expansions(head.k, head.eps,
                                                 head.method,
                                                 self.compressed,
                                                 offered=True)
            if cost <= self._deficit[tenant]:
                queue.popleft()
                self._deficit[tenant] -= cost
                sched.pending.remove(head)
                if not queue:
                    self._deactivate(tenant)
                # else: stay on this tenant — its deficit may cover more
                return head
            self._ptr = (self._ptr + 1) % len(self._active)
            self._fresh_visit = True


class SloCostPolicy(AdmissionPolicy):
    """Shed / defer / order admission from predicted service vs SLO budget.

    Each tenant has a latency budget (``budgets`` overrides ``budget``; a
    ``None`` budget means best-effort: never shed or deferred by this
    policy, drained after all budgeted traffic). At submit:

    * predicted service alone exceeds the budget -> ``SHED`` — the request
      cannot meet its SLO even on an idle system, so retrying is pointless
      (this subsumes the legacy boolean ``shed`` callback, which remains
      supported and runs first).
    * predicted queue wait + service exceeds the budget -> ``DEFER`` — the
      request *would* fit on a drained system; the caller may retry later
      (``defer=False`` converts these to sheds).

    The queue drains earliest-deadline-first (deadline = submit time +
    budget; ties and best-effort traffic fall back to submission order),
    so tight-budget requests jump the queue instead of missing their SLO
    behind lax ones.

    Until the cost model has timed one request, predicted service is 0.0
    and everything admits — cold-start admission errs open by design (the
    scheduler's prewarm/warmup traffic calibrates seconds-per-expansion
    before real load arrives).

    Cache pricing note: unlike ``drr`` (which bills *offered* traffic and
    so discounts by the learned cache-hit probability), this policy prices
    at the admitted rate deliberately — a request consulted here has
    *already missed* the semantic cache (the scheduler probes before the
    policy), so its service cost is the full one, and every queued or
    in-flight request in the backlog estimate is likewise a miss.
    Discounting would admit requests that then blow their SLO.
    """

    name = "slo_cost"

    def __init__(self, budget: float | None = None,
                 budgets: dict | None = None, *, defer: bool = True,
                 headroom: float = 1.0):
        super().__init__()
        self.budget = budget
        self.budgets = dict(budgets or {})
        self.defer = defer
        if headroom <= 0:
            raise ValueError(f"headroom={headroom} must be positive")
        self.headroom = float(headroom)

    def budget_for(self, tenant: str) -> float | None:
        return self.budgets.get(tenant, self.budget)

    def _predicted_wait(self) -> float:
        """Expected queue wait: backlog (pending + in-flight) in predicted
        expansions, spread over the lanes, at the learned time rate."""
        model = self.model
        if model.sec_per_expansion <= 0:
            return 0.0
        compressed = self.compressed
        backlog = sum(model.predict_expansions(r.k, r.eps, r.method,
                                               compressed)
                      for r in self.sched.pending)
        backlog += sum(model.predict_expansions(r.k, r.eps, r.method,
                                                compressed)
                       for r in self.sched.inflight.values())
        return backlog * model.sec_per_expansion / self.sched.num_lanes

    def on_submit(self, req) -> str:
        budget = self.budget_for(req.tenant)
        if budget is None:
            return ADMIT
        budget *= self.headroom
        service = self.model.predict_service(req.k, req.eps, req.method,
                                             self.compressed)
        if service > budget:
            return SHED
        if self._predicted_wait() + service > budget:
            return DEFER if self.defer else SHED
        return ADMIT

    def _deadline(self, req) -> tuple:
        budget = self.budget_for(req.tenant)
        deadline = math.inf if budget is None else req.t_submit + budget
        return (deadline, req.rid)   # rid tiebreak = submission order

    def pop_next(self):
        sched = self.sched
        if not sched.pending:
            return None
        req = min(sched.pending, key=self._deadline)
        sched.pending.remove(req)
        return req


_POLICIES = {p.name: p for p in (FifoPolicy, DrrPolicy, SloCostPolicy)}


def make_policy(policy) -> AdmissionPolicy:
    """Resolve a policy spec: an ``AdmissionPolicy`` instance passes
    through; a name (``"fifo"`` / ``"drr"`` / ``"slo_cost"``) constructs
    that policy with defaults."""
    if isinstance(policy, AdmissionPolicy):
        return policy
    try:
        return _POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown admission policy {policy!r} "
            f"(known: {sorted(_POLICIES)}, or pass an AdmissionPolicy)"
        ) from None
