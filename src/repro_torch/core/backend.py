"""The backend contract the continuous-batching scheduler drives (port of
``repro.core.backend``).

* ``LaneRequest`` — what a backend needs to serve one request: the query
  vector plus its own ``(k, eps, ef, method, max_K)``. The scheduler's
  ``Request`` subclasses it, so scheduler requests flow into ``admit``
  unwrapped.
* ``LaneBackend`` — the structural protocol: a fixed set of lanes the
  scheduler admits requests into, steps and harvests. Implementations:
  ``core.batch_progressive.ProgressiveEngine``,
  ``sharded_search.engine.ShardedEngine`` and the write-path decorator
  ``index.mutable.MutableBackend``.
* ``RescalableBackend`` — a ``LaneBackend`` whose mesh can follow traffic.
  No backend of this package implements it yet, so the scheduler's
  ``elastic=`` refuses every one of them.

Lifecycle of one lane, as the scheduler drives it::

    free_lanes() -> admit(lane, request) -> step() ... step()
        -> harvest() yields (lane, result) once the lane finishes
        -> recycle(lane) returns the slot to free_lanes()

``harvest()`` must follow every ``step()`` before the next refill: a
finished lane's result is retrievable only until the lane is reused. The
``DiverseResult.stats`` a backend hands back carry the lane's real counters
(``expansions``, ``search_calls``): the serving layer's
``ExpansionCostModel`` learns per-request cost from them.

Python 3.12 checks ``isinstance`` against a runtime-checkable protocol with
``inspect.getattr_static``, so a backend must define every member itself;
members reached through ``__getattr__`` do not count.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np


@dataclasses.dataclass(eq=False)
class LaneRequest:
    """One diverse-search request, the way a backend sees it.

    ``ef`` <= 0 means "backend default"; ``max_K`` caps the progressive
    candidate budget (the paper's N/A guard). Compares by identity.
    """
    q: np.ndarray
    k: int
    eps: float
    ef: int = 0
    method: str = "pss"
    max_K: int | None = None


@runtime_checkable
class LaneBackend(Protocol):
    """Structural protocol — duck-typed, checked by tests via isinstance."""

    num_lanes: int
    max_k: int
    default_ef: int
    #: methods this backend can serve; methods[0] is the scheduler default
    methods: tuple
    #: True when search rounds score a compressed (quantized) corpus; the
    #: cost model prices such traffic in buckets of its own
    compressed: bool

    @property
    def bytes_per_vector(self) -> float:
        """Stored corpus bytes per vector on the device."""
        ...

    @property
    def signature_log(self):
        """The backend's ``SignatureLog`` (shape-class auditing)."""
        ...

    def free_lanes(self) -> np.ndarray:
        """Indices of lanes a new request may be admitted into."""
        ...

    def active_count(self) -> int:
        """Number of occupied (not yet harvested) lanes."""
        ...

    def admit(self, lane: int, request: LaneRequest) -> None:
        """Hand a free lane to ``request`` (fresh per-lane state)."""
        ...

    def step(self):
        """Advance every occupied lane one progressive round."""
        ...

    def harvest(self) -> list:
        """``[(lane, DiverseResult), ...]`` for every lane that finished
        since the last harvest; the lane stays reserved until ``recycle``."""
        ...

    def recycle(self, lane: int) -> None:
        """Return a harvested lane's slot to the free pool."""
        ...

    def prewarm(self, *, max_capacity: int | None = None, ks: tuple = (),
                widths: tuple = ()):
        """Run every stage once per shape class ahead of serving."""
        ...


@runtime_checkable
class RescalableBackend(LaneBackend, Protocol):
    """A ``LaneBackend`` whose capacity can follow traffic (contract 16):
    ``prepare_rescale`` builds a target mesh ahead of load, ``rescale``
    migrates every in-flight lane to it between rounds."""

    @property
    def num_shards(self) -> int:
        """Shard count of the mesh currently serving."""
        ...

    def prepare_rescale(self, shards: int, mesh, index=None, *,
                        prewarm: bool = True):
        """Build + prewarm an elastic target mesh ahead of the scale
        event."""
        ...

    def rescale_options(self) -> tuple[int, ...]:
        """Shard counts servable right now (current + prepared targets)."""
        ...

    def rescale(self, shards: int) -> bool:
        """Migrate corpus + in-flight lanes to the prepared ``shards``
        mesh; False if already there."""
        ...
