"""``DiverseVectorDB``: the one front door to the serving stack (port of
``repro.db``).

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
``db.index``, ``db.cache``). The graph or shards and the engine live on
``device`` (``cuda`` unless given); the corpus buffer, the delta and the
bitmap stay on the host. The mesh is P shards on that one device
(``compat.LocalMesh``), or one shard per rank of a process group
(``mesh=`` a ``compat.ProcessGroupMesh``, or ``shards="auto"`` inside a
default group): every rank calls the same constructor on the same rows and
builds only its own shard; rank 0 owns the scheduler and the cache and
serves, every other rank follows rank 0's operations
(``serve.scheduler.follow``) inside its constructor until rank 0's
``close()``. ``quantized=`` without ``shards=`` raises
``NotImplementedError``: the reference's single-host engine cannot serve a
quantized graph either, so there is nothing to port; pass ``shards=`` with
``quantized=``.
"""
from __future__ import annotations

import numpy as np

from repro_torch import compat
from repro_torch.core.batch_progressive import ProgressiveEngine
from repro_torch.core.graph import FlatGraph
from repro_torch.core.pgs import DiverseResult
from repro_torch.index.mutable import (MutableBackend, MutableIndex,
                                       refuse_unported)
from repro_torch.serve.query import Query
from repro_torch.serve.scheduler import (LaneScheduler, RequestDeferred,
                                         RequestShed, SchedulerSaturated,
                                         follow)
from repro_torch.sharded_search.engine import ShardedEngine

__all__ = ["DiverseVectorDB", "Query"]


class DiverseVectorDB:
    """Index + engine + scheduler + cache behind one constructor.

    ``vectors`` (float ``[n, d]``, a graph is built over them and placed
    on the device: ``builder="knng"`` a KNN graph, ``"hnsw"`` the paper's
    HNSW index) or a prebuilt ``index=`` (a ``FlatGraph``) seeds the
    corpus; ``metric`` in {"l2", "ip", "cos"}.

    * ``shards=None`` serves single-host (``ProgressiveEngine``); an int
      builds a ``ShardedEngine`` over that many shards (``mesh=``
      optionally supplies the mesh; by default one of ``shards`` on the
      ``axis`` axis). The corpus is padded with tombstoned rows to split
      evenly. ``shards="auto"`` picks the largest power of two
      ``compat.device_count()`` allows (the world size inside a default
      process group) — or, under ``elastic=``, half of it, leaving room to
      grow.
    * ``mesh=`` a ``compat.ProcessGroupMesh`` (or ``shards="auto"`` inside
      a default group, over its whole world) serves one shard per rank: the
      serving mesh is the group's first ``shards`` ranks (``mesh.sub``),
      and the elastic targets' sub-meshes are made here on every rank. On
      rank 0 the constructor returns a serving facade; on every other rank
      it follows rank 0 until rank 0's ``close()`` and then returns one
      that serves nothing (``scheduler`` None).
    * ``elastic=`` (True or a ``serve.scheduler.ElasticPolicy``) makes the
      sharded mesh follow traffic (contract 16): the two standard targets
      (the device-count power of two and its half) are resharded and
      prepared at construction, each with ``num_lanes * t // shards``
      lanes, and the scheduler migrates the corpus and every in-flight
      lane between them on sustained queue depth, at the pump boundary.
      The corpus is padded to divisibility by the larger target.
    * ``quantized`` in {None, "int8", "pq"} (with ``shards=``) stores the
      shards compressed (exact float rerank before certificates, contract
      13; the delta keeps int8 codes too and is always float-reranked).
    * ``cache_size=N`` attaches the semantic result cache, live-bound to
      the mutable index so hits revalidate against the written corpus;
      ``policy`` / ``cost_model`` configure admission
      (``serve.policies``).
    * ``embed=`` (a ``str -> vector`` callable) enables text queries.
    * ``num_lanes`` / ``max_k`` / ``default_ef`` / ``M`` / ``builder`` /
      ``delta_capacity`` / ``background_rebuild`` / ``seed`` size the
      stack; ``backend_kw`` passes extra engine knobs through (e.g.
      ``dict(kernel_impl="ref")`` single-host, ``dict(K0=16,
      resume="beam")`` sharded); ``scheduler_kw`` likewise for
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
                 mesh=None, axis: str = "data", prewarm: bool = True,
                 elastic=None, seed: int = 0, backend_kw: dict | None = None,
                 scheduler_kw: dict | None = None, device=None):
        refuse_unported(shards=shards, quantized=quantized)
        self.embed = embed
        self._closed = False
        elastic = elastic or None
        world = mesh if isinstance(mesh, compat.ProcessGroupMesh) else None
        if (world is None and mesh is None and shards == "auto"
                and compat.in_process_group()):
            world = compat.make_process_mesh((compat.device_count(),),
                                             (axis,), device=device)
        #: the process group's mesh of every rank (None on one process)
        self.world = world
        n_dev = world.size if world is not None else compat.device_count()
        shard_align = None
        elastic_targets: tuple[int, ...] = ()
        if shards == "auto" or elastic is not None:
            p_big = 1
            while p_big * 2 <= n_dev:
                p_big *= 2
        if shards == "auto":
            # leave room to grow when elastic; otherwise the whole mesh
            shards = max(1, p_big // 2) if elastic is not None else p_big
        if elastic is not None:
            if shards is None:
                raise ValueError("elastic= needs a sharded backend — pass "
                                 "shards=int or shards='auto'")
            if p_big < 2:
                raise ValueError(
                    "elastic serving needs >= 2 devices to scale between "
                    f"(found {n_dev})")
            p_small = p_big // 2
            if shards not in (p_small, p_big):
                raise ValueError(
                    "elastic serving scales between the standard targets "
                    f"{p_small} and {p_big}; start on one of them (got "
                    f"shards={shards})")
            elastic_targets = tuple(t for t in (p_small, p_big)
                                    if t != shards)
            shard_align = p_big
        target_meshes = {}
        if world is not None:
            if shards is None or shards > world.size:
                raise ValueError(
                    f"a process group of {world.size} ranks serves 1 to "
                    f"{world.size} shards, got shards={shards}")
            # every rank makes the sub-groups, in this order
            mesh = world.sub(shards)
            target_meshes = {t: world.sub(t) for t in elastic_targets}
        self.index = MutableIndex(
            vectors, metric, graph=index, delta_capacity=delta_capacity,
            M=M, builder=builder, shards=shards, shard_align=shard_align,
            quantized=quantized, background=background_rebuild, seed=seed,
            device=device, rank=None if world is None else world.rank)
        backend_kw = dict(backend_kw or {})
        if shards is not None:
            if mesh is None:
                mesh = compat.make_mesh((shards,), (axis,),
                                        device=self.index.device)
            self.mesh = mesh
            n_epoch = (self.index.sharded.num_shards
                       * self.index.sharded.shard_size)
            engine = ShardedEngine(
                self.index.sharded, self.index.float_view()[:n_epoch],
                mesh, num_lanes, axis=axis, max_k=max_k,
                default_ef=default_ef, **backend_kw)
        else:
            self.mesh = None
            engine = ProgressiveEngine(
                self.index.graph, num_lanes, max_k=max_k,
                default_ef=default_ef, **backend_kw)
        self.backend = MutableBackend(engine, self.index)
        if world is not None and world.rank != 0:
            # rank 0 decides: its scheduler's prewarm, the targets below,
            # every write, swap, admission and round reach this rank here
            self.scheduler = None
            self.follower_steps = follow(self.backend)
            self._closed = True
            return
        skw = dict(scheduler_kw or {})
        self.scheduler = LaneScheduler(
            backend=self.backend, policy=policy, cost_model=cost_model,
            cache_size=cache_size, prewarm=prewarm, elastic=elastic, **skw)
        # the scale event's costs are paid here (contract 16): the corpus
        # resharded onto each elastic target and its dispatch ladder run
        # once, so the scheduler's trigger only migrates between rounds.
        # Serving capacity follows the mesh: a target's lane count scales
        # with its shards (floor 1), so a grow adds lanes and a shrink
        # returns them.
        for t in elastic_targets:
            self.scheduler.backend.prepare_rescale(
                t, target_meshes.get(t) or compat.make_mesh(
                    (t,), (axis,), device=self.index.device),
                M=M, builder=builder, prewarm=prewarm,
                max_capacity=skw.get("prewarm_capacity"),
                ks=tuple(skw.get("prewarm_ks") or ()),
                num_lanes=max(1, num_lanes * t // shards))

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
        backend = self.scheduler.backend   # over ranks: broadcast
        backend.request_rebuild()
        if not wait:
            return False
        self.index.wait_rebuild()
        self.scheduler.drain()
        return backend.maybe_swap()

    def close(self) -> None:
        """End the other ranks' loops (a facade over a process group; the
        facade serves no more after it). Nothing to do on one process."""
        if not self._closed and self.scheduler is not None:
            self.scheduler.close()
        self._closed = True

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        """One snapshot: the scheduler's ``latency_stats()`` plus the
        mutable index's corpus/epoch counters under ``"index"`` and the
        backend's swap count under ``"epoch_swaps"``."""
        out = self.scheduler.latency_stats()
        out["index"] = self.index.stats()
        out["epoch_swaps"] = self.backend.swaps
        return out
