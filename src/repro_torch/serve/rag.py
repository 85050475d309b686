"""RAG serving pipeline: diverse retrieval (the paper) + LM decode (port of
``repro.serve.rag``).

The paper's motivating application — a retrieval step whose results are
*diverse* under a user-chosen epsilon feeding a generator. This module wires
the two halves of the framework together:

    db = DiverseVectorDB(index=graph)
    pipeline = RagPipeline(cfg, params, db=db, k=5, eps=0.8)
    tokens, ids, certified = pipeline.generate(query_embeds, prompt_tokens,
                                               steps=32)

Retrieval defaults to the continuous-batching lane scheduler
(``serve.scheduler.LaneScheduler``): requests are submitted with their own
``(k, eps)``, lanes freed by Theorem-2-certified queries are recycled for
queued requests, and each request's result is bit-identical to a fresh
per-query PSS driver. ``engine="lockstep"`` runs the same engine with
whole-batch admission; ``engine="fixed_k"`` keeps the older static-K hybrid
(batched div-A* + per-query PSS repair) for comparison.

Retrieval wiring goes through ``repro_torch.db.DiverseVectorDB`` (pass
``db=``): the facade owns index/backend/scheduler/cache assembly, adds the
write path (``db.upsert``/``db.delete`` are visible to this pipeline's next
``retrieve``), and serves sharded corpora through the same constructor. The
pre-facade wirings — ``graph=`` (build a single-host scheduler here, on the
graph's device) and ``backend=`` (wrap a hand-built engine) — still work
but are **deprecated shims**: they emit ``DeprecationWarning`` (results are
bit-exact either way). ``policy=`` picks the scheduler's admission policy
and ``retrieve(..., tenants=...)`` labels each query's tenant;
``cache_size=`` enables the semantic result cache.

Generation runs on the parameters' device: the retrieved ids become
context tokens, a teacher-forced prefill by repeated ``decode_step``, then
greedy decode.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.batch import batch_optimal_diverse
from repro_torch.core.batch_progressive import batch_pss
from repro_torch.core.graph import FlatGraph
from repro_torch.core.pss import pss
from repro_torch.models import model as M
from repro_torch.serve.query import Query
from repro_torch.serve.scheduler import (LaneScheduler, RequestDeferred,
                                         RequestShed, SchedulerSaturated)


@dataclasses.dataclass
class RagPipeline:
    cfg: ModelConfig
    params: torch.nn.Module
    graph: FlatGraph | None = None   # deprecated shim — pass db= instead
    k: int = 5
    eps: float = 0.8
    K_budget: int = 64
    ef: int = 8
    engine: str = "scheduler"   # "scheduler" | "lockstep" | "fixed_k"
    num_lanes: int = 8
    prewarm: bool = False
    backend: object | None = None   # deprecated shim — pass db= instead
    policy: object = "fifo"     # admission policy name or AdmissionPolicy
    cache_size: int = 0         # semantic result cache capacity (0 = off)
    cost_model: object | None = None   # warm ExpansionCostModel (else fresh)
    db: object | None = None    # repro_torch.db.DiverseVectorDB
    _scheduler: LaneScheduler | None = dataclasses.field(
        default=None, repr=False)

    @property
    def scheduler(self) -> LaneScheduler:
        """The pipeline's lane scheduler (the ``db``'s when one was given;
        otherwise built lazily through a deprecated wiring shim, reused
        across calls so the backend's lane state and the admission
        policy's cost model persist)."""
        if self.db is not None:
            return self.db.scheduler
        if self._scheduler is None:
            if self.backend is not None:
                warnings.warn(
                    "RagPipeline(backend=...) is a deprecated wiring shim — "
                    "construct a repro_torch.db.DiverseVectorDB and pass "
                    "db=; the shim is removed one release after "
                    "DiverseVectorDB (results are bit-exact either way)",
                    DeprecationWarning, stacklevel=3)
                self._scheduler = LaneScheduler(
                    backend=self.backend, prewarm=self.prewarm,
                    policy=self.policy, cache_size=self.cache_size,
                    cost_model=self.cost_model)
            else:
                warnings.warn(
                    "RagPipeline(graph=...) is a deprecated wiring shim — "
                    "construct repro_torch.db.DiverseVectorDB(index=graph, "
                    "...) and pass db=; the shim is removed one release "
                    "after DiverseVectorDB (results are bit-exact either "
                    "way)", DeprecationWarning, stacklevel=3)
                self._scheduler = LaneScheduler(
                    self.graph, num_lanes=self.num_lanes,
                    max_k=max(self.k, 16), default_ef=self.ef,
                    prewarm=self.prewarm, policy=self.policy,
                    cache_size=self.cache_size,
                    cost_model=self.cost_model, device=self.graph.device)
        return self._scheduler

    def _graph(self) -> FlatGraph:
        if self.graph is not None:
            return self.graph
        if self.db is not None and self.db.index.graph is not None:
            return self.db.index.graph
        raise ValueError("this engine mode needs a single-host graph "
                         "(pass graph= or a single-host db=)")

    def _retrieve_queries(self, queries: list[Query]
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Serve a closed batch of ``Query`` objects through the scheduler
        (the ``Query``-native path ``retrieve`` dispatches to)."""
        sched = self.scheduler
        embed = self.db.embed if self.db is not None else None
        reqs = []
        for q in queries:
            q = q.resolve(embed)
            while True:
                try:
                    reqs.append(sched.submit(q))
                    break
                except RequestShed:
                    reqs.append(None)
                    break
                except (SchedulerSaturated, RequestDeferred):
                    sched.pump()
        sched.drain()
        k_max = max(int(q.k) for q in queries)
        ids = np.full((len(queries), k_max), -1, np.int32)
        cert = np.zeros(len(queries), bool)
        for i, r in enumerate(reqs):
            if r is None or r.result is None:
                continue
            ids[i, :r.result.ids.shape[0]] = r.result.ids
            cert[i] = r.result.stats.certified
        return ids, cert

    def retrieve(self, query_embeds, ks=None, epss=None, tenants=None
                 ) -> tuple[np.ndarray, np.ndarray]:
        """Diverse document ids per query + per-lane certificate flags.

        ``query_embeds`` is an ``[m, d]`` embedding batch — or a list of
        ``serve.query.Query`` objects, each carrying its own
        ``k``/``eps``/``tenant``/``slo`` (``ks``/``epss``/``tenants`` must
        then be omitted). With raw embeddings, ``ks``/``epss`` optionally
        override the pipeline defaults per request and ``tenants`` labels
        each request's tenant for the admission policy and per-tenant
        stats (scheduler engine only). A request shed by the policy yields
        an all ``-1`` id row with ``certified=False``.
        """
        if (isinstance(query_embeds, (list, tuple)) and query_embeds
                and all(isinstance(q, Query) for q in query_embeds)):
            if ks is not None or epss is not None or tenants is not None:
                raise ValueError("per-Query parameters are set on each "
                                 "Query, not as retrieve() overrides")
            if self.engine != "scheduler":
                raise ValueError("Query batches are served by the "
                                 "scheduler engine only")
            return self._retrieve_queries(list(query_embeds))
        qs = np.asarray(query_embeds.cpu() if isinstance(
            query_embeds, torch.Tensor) else query_embeds, np.float32)
        if self.engine == "scheduler":
            results = self.scheduler.run(
                qs, ks if ks is not None else self.k,
                epss if epss is not None else self.eps, efs=self.ef,
                tenants=tenants)
            k_max = int(np.max(np.broadcast_to(
                np.asarray(ks if ks is not None else self.k),
                (qs.shape[0],))))
            ids = np.full((qs.shape[0], k_max), -1, np.int32)
            cert = np.zeros(qs.shape[0], bool)
            for i, r in enumerate(results):
                if r is None:   # shed by the admission policy
                    continue
                ids[i, :r.ids.shape[0]] = r.ids
                cert[i] = r.stats.certified
            return ids, cert
        if self.engine in ("lockstep", "progressive"):   # the older name kept
            res = batch_pss(self._graph(), qs, self.k, self.eps, ef=self.ef)
            return res.ids.copy(), res.stats.certified.copy()
        # legacy hybrid: static-K batched div-A* + per-query PSS repair
        ids, _, _, certified = batch_optimal_diverse(
            self._graph(), qs, self.k, self.eps, self.K_budget, self.ef)
        ids = ids.cpu().numpy()   # a writable copy for the PSS repair
        cert = certified.cpu().numpy()
        for i in np.flatnonzero(~cert):
            res = pss(self._graph(), qs[i], self.k, self.eps, ef=self.ef * 4)
            ids[i] = res.ids
        return ids, cert

    def generate(self, query_embeds, prompt_tokens, steps: int = 16,
                 max_seq: int | None = None, tenants=None):
        """Retrieve diverse context, prepend retrieved ids as context tokens
        (toy fusion — document tokens would be spliced here), decode.
        ``tenants`` flows through to ``retrieve`` (per-tenant scheduling).
        Returns (tokens int32[B, steps], ids, certified) on the host."""
        ids, cert = self.retrieve(query_embeds, tenants=tenants)
        b, p = prompt_tokens.shape
        max_seq = max_seq or (p + steps + self.k)
        device = self.params.embed.device
        # Python's floor modulo: a shed row's -1 becomes vocab_size - 1
        ctx = torch.remainder(torch.as_tensor(ids, dtype=torch.int64),
                              self.cfg.vocab_size)
        toks = torch.cat([ctx, torch.as_tensor(
            np.asarray(prompt_tokens), dtype=torch.int64)], dim=1).to(device)
        cache = M.init_cache(self.cfg, b, max_seq, device=device)
        # teacher-forced prefill via repeated decode (keeps one code path)
        out = []
        for t in range(toks.shape[1]):
            logits, cache = M.decode_step(self.cfg, self.params, cache,
                                          toks[:, t:t + 1])
        tok = torch.argmax(logits[:, -1:], dim=-1)
        for _ in range(steps):
            out.append(tok)
            logits, cache = M.decode_step(self.cfg, self.params, cache, tok)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        tokens = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
        return tokens, ids, cert
