"""``DiverseVectorDB``: the one front door to the serving stack (port of
``repro.db``, single-host branch).

The facade assembles index → backend → scheduler → cache from one
constructor and exposes the complete serving surface:

* ``search(query)`` — one diverse search (a ``serve.query.Query``, an
  embedding, or text when constructed with ``embed=``), served through the
  scheduler: admission policies, semantic cache, continuous batching.
* ``upsert(vectors)`` / ``delete(ids)`` — the write path: writes are
  admitted through the scheduler alongside reads, land in the mutable
  index's delta segment / deletion bitmap at the next pump boundary,
  invalidate intersecting cache entries, and trigger background
  rebuild-and-epoch-swap when the delta fills (contract 15).
* ``search_batch(queries)`` — a closed batch, continuously batched over
  the backend's lanes.
* ``stats()`` — scheduler latency stats + index (epoch/delta/bitmap)
  stats in one snapshot.

Everything underneath stays reachable (``db.scheduler``, ``db.backend``,
``db.index``, ``db.cache``). The graph and the engine live on ``device``
(``cuda`` unless given); the corpus buffer, the delta and the bitmap stay
on the host. ``shards=``, ``elastic=``, ``quantized=`` and
``builder="hnsw"`` raise ``NotImplementedError`` naming the ROADMAP item
each waits on.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.batch_progressive import ProgressiveEngine
from repro_torch.core.graph import FlatGraph
from repro_torch.core.pgs import DiverseResult
from repro_torch.index.mutable import (MutableBackend, MutableIndex,
                                       refuse_unported)
from repro_torch.serve.query import Query
from repro_torch.serve.scheduler import (LaneScheduler, RequestDeferred,
                                         RequestShed, SchedulerSaturated)

__all__ = ["DiverseVectorDB", "Query"]


class DiverseVectorDB:
    """Index + engine + scheduler + cache behind one constructor.

    ``vectors`` (float ``[n, d]``, a KNN graph is built over them on the
    device) or a prebuilt ``index=`` (a ``FlatGraph``) seeds the corpus;
    ``metric`` in {"l2", "ip", "cos"}.

    * ``cache_size=N`` attaches the semantic result cache, live-bound to
      the mutable index so hits revalidate against the written corpus;
      ``policy`` / ``cost_model`` configure admission
      (``serve.policies``).
    * ``embed=`` (a ``str -> vector`` callable) enables text queries.
    * ``num_lanes`` / ``max_k`` / ``default_ef`` / ``M`` /
      ``delta_capacity`` / ``background_rebuild`` size the stack;
      ``backend_kw`` passes extra ``ProgressiveEngine`` knobs through
      (e.g. ``dict(kernel_impl="ref")``); ``scheduler_kw`` likewise for
      ``LaneScheduler`` (e.g. ``dict(admission="lockstep",
      prewarm_capacity=1024)``).
    """

    def __init__(self, vectors=None, metric: str = "l2", *,
                 index: FlatGraph | None = None,
                 shards: int | str | None = None,
                 quantized: str | None = None,
                 cache_size: int = 0, policy="fifo", cost_model=None,
                 embed=None, num_lanes: int = 8, max_k: int = 16,
                 default_ef: int = 40, M: int = 16, builder: str = "knng",
                 delta_capacity: int = 256, background_rebuild: bool = True,
                 prewarm: bool = True, elastic=None,
                 backend_kw: dict | None = None,
                 scheduler_kw: dict | None = None, device=None):
        refuse_unported(shards=shards, quantized=quantized, builder=builder,
                        elastic=elastic)
        self.embed = embed
        self.index = MutableIndex(
            vectors, metric, graph=index, delta_capacity=delta_capacity,
            M=M, builder=builder, background=background_rebuild,
            device=device)
        engine = ProgressiveEngine(
            self.index.graph, num_lanes, max_k=max_k,
            default_ef=default_ef, **dict(backend_kw or {}))
        self.backend = MutableBackend(engine, self.index)
        self.scheduler = LaneScheduler(
            backend=self.backend, policy=policy, cost_model=cost_model,
            cache_size=cache_size, prewarm=prewarm,
            **dict(scheduler_kw or {}))

    @property
    def cache(self):
        return self.scheduler.cache

    @property
    def engine(self):
        return self.backend.inner

    # -- reads ---------------------------------------------------------------
    def _as_query(self, query, k, eps, kw) -> Query:
        if isinstance(query, Query):
            if k is not None or eps is not None or kw:
                raise ValueError(
                    "search(Query) takes no overrides — set the fields on "
                    "the Query itself (dataclasses.replace)")
            return query
        if k is None or eps is None:
            raise TypeError("search needs (query, k=, eps=) or a Query")
        return Query(query, k=int(k), eps=float(eps), **kw)

    def search(self, query, k: int | None = None, eps: float | None = None,
               **kw) -> DiverseResult:
        """Serve one diverse search to completion; returns its
        ``DiverseResult``.

        ``query`` is a ``Query``, an embedding, or text (``embed=`` was
        given); with a raw embedding/text, ``k=``/``eps=`` are required and
        the remaining ``Query`` fields (``method``, ``tenant``, ``slo``,
        ``ef``, ``max_K``) ride as keywords. Backpressure and policy
        deferral are absorbed by pumping; a policy *shed* raises
        ``RequestShed`` (the policy's verdict is deterministic — there is
        nothing to retry).
        """
        q = self._as_query(query, k, eps, kw).resolve(self.embed)
        while True:
            try:
                req = self.scheduler.submit(q)
                break
            except (SchedulerSaturated, RequestDeferred):
                self.scheduler.pump()
        while req.result is None:
            self.scheduler.pump()
        return req.result

    def search_batch(self, queries, k=None, eps=None, **kw) -> list:
        """Serve a closed batch (list of ``Query``, or an ``[m, d]``
        embedding array with broadcast ``k=``/``eps=``), continuously
        batched over the lanes; results in submission order (``None`` for
        a request the admission policy shed)."""
        if not isinstance(queries, (list, tuple)):
            arr = np.asarray(queries, np.float32)
            queries = [self._as_query(arr[i], k, eps, kw)
                       for i in range(arr.shape[0])]
        elif k is not None or eps is not None or kw:
            raise ValueError("per-Query parameters are set on each Query")
        reqs = []
        for q in queries:
            q = q.resolve(self.embed)
            while True:
                try:
                    reqs.append(self.scheduler.submit(q))
                    break
                except RequestShed:
                    reqs.append(None)
                    break
                except (SchedulerSaturated, RequestDeferred):
                    self.scheduler.pump()
        self.scheduler.drain()
        return [r.result if r is not None else None for r in reqs]

    # -- writes --------------------------------------------------------------
    def upsert(self, vectors) -> np.ndarray:
        """Add fresh vectors to the live corpus; returns their assigned ids.

        The write is admitted through the scheduler (shared front door with
        reads) and applied immediately at this pump boundary: subsequent
        searches see the new points via the delta merge, intersecting cache
        entries are evicted, and a full delta triggers a background
        rebuild + epoch swap. In-flight searches pick the write up at
        harvest (contract 15)."""
        ticket = self.scheduler.submit_write("upsert", vectors)
        self.scheduler.apply_writes()
        return ticket.ids

    def delete(self, ids) -> int:
        """Tombstone ids in the live corpus; returns how many ids the
        delete named. Served sets never contain a deleted id from this
        point on (bitmap filter at harvest + cache invalidation)."""
        ticket = self.scheduler.submit_write("delete", ids)
        self.scheduler.apply_writes()
        return int(np.asarray(ticket.ids).size)

    def rebuild(self, wait: bool = True) -> bool:
        """Force a rebuild of the epoch graph over the current rows; with
        ``wait`` the built graph is also swapped in (the engine is drained
        first — the swap needs idle lanes). Returns True if the swap was
        installed."""
        self.index.request_rebuild()
        if not wait:
            return False
        self.index.wait_rebuild()
        self.scheduler.drain()
        return self.backend.maybe_swap()

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        """One snapshot: the scheduler's ``latency_stats()`` plus the
        mutable index's corpus/epoch counters under ``"index"`` and the
        backend's swap count under ``"epoch_swaps"``."""
        out = self.scheduler.latency_stats()
        out["index"] = self.index.stats()
        out["epoch_swaps"] = self.backend.swaps
        return out
