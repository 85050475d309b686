"""Distributed ADk-NNS over P shards on one device (port of
``repro.sharded_search.search``).

The database is partitioned into P contiguous shards, each with its own
proximity graph. Every query runs one beam search per shard (shard-local
ids, offset to global ids by the shard's base), the shards' top-K lists
combine through a tournament merge — log2(P) butterfly rounds of a
pairwise top-K merge, run as one ``kernels.ops.topk_tournament`` call — or
an all-gather and one sort, and diversification (div-A* or greedy) runs on
the merged candidates.
Quantized indexes score compressed codes in the beams and rerank the merged
frontier in float before diversifying (contract 13).

How the mesh maps onto one device (``compat.LocalMesh``): per-shard arrays
keep the reference's leading shard axis, and where the reference vmaps one
``while_loop`` per (shard, lane) under ``shard_map``, here all P * B (shard,
lane) pairs step in one lockstep loop over the stacked corpus
(``_corpus_parts``): queue ids stay shard-local, as in the reference, and
the loop adds each pair's row offset where it reads rows. Each pair ends
where its own loop would, so results are the reference's pair by pair.

Over a process group (``compat.ProcessGroupMesh``, one shard per rank) the
same code runs on a leading axis of one: each rank's index holds its own
shard (``local_shard`` of ``index_to_host``, with the global shard count
and its base), its beams run its B pairs, the tournament is the
reference's butterfly (log2(P) rounds, each an ``exchange`` with rank
``me ^ stride`` and one two-run ``kops.topk_merge`` launch), and the
all-gather merge and the expansion counts go through the group. The
merged candidates, and everything after them, are replicated on every
rank; ``all_vectors`` stays whole on each. A rank outside the mesh (a
sub-mesh of the group's first ranks) holds an index with no local shard
(``local_shards`` 0) and takes part in none of its collectives. Such an
index is built per rank (``build_sharded_index(shard=)``), resharded per
rank from the host rows every rank keeps (``reshard_index(shard=)``), and
the in-flight state migrates by one gather of the old mesh's blocks over
the whole group (``migrate_sharded_state(old_mesh=)``).

``sharded_topk`` / ``sharded_diverse_search`` are the scratch half (one
fixed budget, no state); ``ShardedSearchState`` with
``sharded_topk_resume`` / ``sharded_diverse_resume`` carry each lane's
per-shard beams across the budget ladder. The reference's compiled-dispatch
cache (``_resume_dispatch_fn``, ``resume_jit_cache_sizes``) has no
counterpart: nothing is compiled. Elastic resharding repartitions the
index (``reshard_index``: rows re-blocked, shard graphs rebuilt) and moves
the in-flight state (``migrate_sharded_state``: every lane's queues
re-bucketed by global id, on the device).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import quant, resolve_device
from repro_torch.core import beam_search as bs
from repro_torch.core import queue as qmod
from repro_torch.core.batch_progressive import _batched_div_astar
from repro_torch.core.bucketing import next_pow2
from repro_torch.core.graph import make_flat_graph
from repro_torch.index.flat import build_knn_graph, rerank_rows
from repro_torch.index.hnsw import build_hnsw
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import sort_top

NEG_INF = float("-inf")
_LEAVES = ("vectors", "neighbors", "entries", "bases", "codes", "scales",
           "codebooks")


@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """Per-shard graphs stacked on a leading shard axis, on one device.

    Float corpora live in ``vectors``. Quantized corpora (``scheme`` set)
    carry ``codes`` — plus ``scales`` (int8) or ``codebooks`` (pq,
    replicated) — and ``vectors`` is None: the float rows stay with the
    caller, on the host, for the exact rerank.
    """
    vectors: torch.Tensor | None     # f32[P, Ns, d]; None when quantized
    neighbors: torch.Tensor          # int32[P, Ns, M0]
    entries: torch.Tensor            # int32[P]
    bases: torch.Tensor              # int32[P] global-id base of each shard
    codes: torch.Tensor | None = None      # int8[P, Ns, d] | uint8[P, Ns, M]
    scales: torch.Tensor | None = None     # f32[P, nb]   (int8 scheme)
    codebooks: torch.Tensor | None = None  # f32[M, C, ds] (pq, replicated)
    metric: str = "l2"
    scheme: str | None = None
    scale_rows: int = 8
    #: the global shard count when this index holds only some of them (a
    #: rank's shard of a process-group mesh); 0: it holds every shard
    total_shards: int = 0

    @property
    def num_shards(self) -> int:
        return self.total_shards or self.neighbors.shape[0]

    @property
    def local_shards(self) -> int:
        """Shards stacked here: all of them, or a rank's one."""
        return self.neighbors.shape[0]

    @property
    def shard_size(self) -> int:
        return self.neighbors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.neighbors.device

    @property
    def dim(self) -> int:
        if self.scheme == "pq":
            m, _, ds = self.codebooks.shape
            return m * ds
        if self.scheme == "int8":
            return self.codes.shape[-1]
        return self.vectors.shape[-1]

    def corpus_bytes_per_vector(self) -> float:
        """Stored corpus bytes per vector of one shard (graph excluded; PQ
        codebooks amortized over one shard)."""
        ns = self.shard_size
        if self.scheme == "int8":
            return (ns * self.codes.shape[-1] + self.scales.shape[-1] * 4) / ns
        if self.scheme == "pq":
            return (ns * self.codes.shape[-1]
                    + self.codebooks.numel() * 4) / ns
        return 4.0 * self.dim


def index_to_host(index: ShardedIndex) -> dict:
    """The index as numpy arrays (None for an absent leaf) plus ``metric``,
    ``scheme`` and ``scale_rows``: the dict ``index_from_host`` reads."""
    host = {f: (None if getattr(index, f) is None
                else getattr(index, f).cpu().numpy()) for f in _LEAVES}
    out = dict(host, metric=index.metric, scheme=index.scheme,
               scale_rows=int(index.scale_rows))
    if index.total_shards:
        out["total_shards"] = int(index.total_shards)
    return out


def local_shard(host: dict, rank: int) -> dict:
    """Shard ``rank`` of a whole index's host dict (``index_to_host``): its
    per-shard leaves on a leading axis of one, the PQ codebooks (shared)
    whole, and the global shard count, for the rank that serves it.
    ``rank`` -1 gives no shard (a leading axis of zero), for a rank outside
    the mesh."""
    p = int(np.asarray(host["neighbors"]).shape[0])
    if not -1 <= rank < p:
        raise ValueError(f"no shard {rank} in an index of {p}")
    at = slice(rank, rank + 1) if rank >= 0 else slice(0, 0)
    out = {f: (None if host.get(f) is None or f == "codebooks"
               else np.asarray(host[f])[at]) for f in _LEAVES}
    out["codebooks"] = host.get("codebooks")
    return dict(out, metric=host["metric"], scheme=host.get("scheme"),
                scale_rows=int(host.get("scale_rows", 8)), total_shards=p)


def index_from_host(host: dict, device=None) -> ShardedIndex:
    """A ``ShardedIndex`` on ``device`` (``cuda`` unless given) from numpy
    leaves under the reference's field names — the carrier through which
    both packages search the same shard graphs."""
    dev = resolve_device(device)
    dtypes = dict(vectors=torch.float32, neighbors=torch.int32,
                  entries=torch.int32, bases=torch.int32,
                  scales=torch.float32, codebooks=torch.float32,
                  codes=torch.uint8 if host.get("scheme") == "pq"
                  else torch.int8)
    leaves = {f: (None if host.get(f) is None else
                  torch.as_tensor(np.array(host[f])).to(dev, dtypes[f])
                  .contiguous()) for f in _LEAVES}
    return ShardedIndex(**leaves, metric=host["metric"],
                        scheme=host.get("scheme"),
                        scale_rows=int(host.get("scale_rows", 8)),
                        total_shards=int(host.get("total_shards", 0)))


def _corpus_parts(index: ShardedIndex):
    """The stacked corpus every (shard, lane) pair reads, and the row
    stride between shards: ``(corpus, stride)``, node v of shard s at row
    ``s * stride + v``.

    Float and PQ shards stack as they are (``stride = Ns``; PQ codebooks
    are shared). An int8 shard's scales cover blocks of ``scale_rows`` of
    its own rows, so its codes are padded to whole blocks first; the
    stacked scales then index the stacked rows."""
    p, ns = index.local_shards, index.shard_size
    if index.scheme is None:
        return index.vectors.reshape(p * ns, -1), ns
    if index.scheme == "int8":
        sr = index.scale_rows
        stride = -(-ns // sr) * sr
        codes = index.codes
        if stride != ns:
            codes = torch.zeros((p, stride, codes.shape[-1]), dtype=codes.dtype,
                                device=codes.device)
            codes[:, :ns] = index.codes
        return quant.Int8Corpus(codes.reshape(p * stride, -1),
                                index.scales.reshape(-1), sr), stride
    return quant.PQCorpus(index.codes.reshape(p * ns, -1),
                          index.codebooks), ns


def _check_builder(builder: str) -> None:
    if builder not in ("knng", "hnsw"):
        raise ValueError(f"unknown builder {builder!r}")


def _shard_graph(chunk: np.ndarray, metric: str, M: int, builder: str,
                 dev: torch.device):
    """One shard's graph, of which the index keeps level 0 and the entry.
    HNSW shards are built with the builder's defaults (ef_construction 200,
    seed 0), as the reference builds them."""
    if builder == "hnsw":
        return build_hnsw(chunk, metric=metric, M=M, device=dev)
    return build_knn_graph(chunk, metric=metric, M=M, device=dev)


def _shards_built(num_shards: int, shard: int | None) -> list[int]:
    """The shards a build keeps: all of them (``shard`` None), one, or
    none (-1)."""
    if shard is None:
        return list(range(num_shards))
    if not -1 <= shard < num_shards:
        raise ValueError(f"no shard {shard} in an index of {num_shards}")
    return [shard] if shard >= 0 else []


def _assemble(x: np.ndarray, num_shards: int, keep: list[int], metric: str,
              M: int, builder: str, scheme: str | None, scale_rows: int,
              codes_of, codebooks, dev) -> ShardedIndex:
    """The index of the shards ``keep`` over the float rows ``x`` (each
    shard's graph built from its own rows; ``codes_of(s, rows)`` its
    compressed rows), with the global shard count where it holds fewer
    than all of them."""
    n, d = x.shape
    ns = n // num_shards
    vecs, nbrs, entries, codes, scales = [], [], [], [], []
    for s in keep:
        chunk = x[s * ns:(s + 1) * ns]
        g = _shard_graph(chunk, metric, M, builder, dev)
        vecs.append(g.vectors)
        nbrs.append(g.neighbors)
        entries.append(int(g.entry))
        if scheme is not None:
            c, sc = codes_of(s, chunk)
            codes.append(c)
            scales.append(sc)
    m0 = max([a.shape[1] for a in nbrs] or [2 * M])
    nbrs = [torch.nn.functional.pad(a, (0, m0 - a.shape[1]), value=-1)
            for a in nbrs]

    def stack(parts, empty_shape, dtype):
        return (torch.stack(parts).contiguous() if parts else
                torch.zeros((0, *empty_shape), dtype=dtype, device=dev))

    code_shape, code_dtype = ((ns, d), torch.int8) if scheme == "int8" else (
        (ns, 0 if codebooks is None else codebooks.shape[0]), torch.uint8)
    return ShardedIndex(
        vectors=None if scheme else stack(vecs, (ns, d), torch.float32),
        neighbors=stack(nbrs, (ns, m0), torch.int32),
        entries=torch.tensor(entries, dtype=torch.int32, device=dev),
        bases=torch.tensor(keep, dtype=torch.int32, device=dev) * ns,
        codes=stack(codes, code_shape, code_dtype) if scheme else None,
        scales=(stack(scales, (-(-ns // scale_rows),), torch.float32)
                if scheme == "int8" else None),
        codebooks=codebooks if scheme == "pq" else None,
        metric=metric, scheme=scheme, scale_rows=int(scale_rows),
        total_shards=0 if len(keep) == num_shards else num_shards)


def build_sharded_index(vectors, num_shards: int, metric: str, M: int = 16,
                        builder: str = "knng", quantized: str | None = None,
                        scale_rows: int = 8, pq_m: int | None = None,
                        pq_codes: int = 256, pq_iters: int = 10,
                        pq_sample: int = 16384, seed: int = 0,
                        device=None, shard: int | None = None
                        ) -> ShardedIndex:
    """Partition the database into contiguous shards and build one graph
    per shard (``builder`` "knng" or "hnsw"; an HNSW shard keeps its level
    0 and entry), on ``device`` (``cuda`` unless given).

    ``quantized`` in {None, "int8", "pq"} selects the stored corpus: graphs
    are always built from the float rows; int8 quantizes each shard on its
    own (one scale per ``scale_rows`` of its rows), PQ trains codebooks on
    the whole corpus and encodes every shard with them. The port's KNN
    builder can differ from the reference's on exactly tied candidates
    (``index_from_host`` carries the reference's shards across instead);
    its HNSW builder gives the reference's graph bit for bit.

    ``shard`` builds one rank's part only: shard ``shard`` on a leading
    axis of one (-1: no shard, for a rank outside the mesh), equal bit for
    bit to ``local_shard`` of the whole build. Every shard's graph is
    built from its own rows, so a rank builds one graph, not P; PQ
    codebooks are trained on the whole corpus on every rank (the same
    seeded training), so each rank's codes are the whole build's.
    """
    _check_builder(builder)
    if quantized is not None and quantized not in quant.QUANT_SCHEMES:
        raise ValueError(f"unknown quantized scheme {quantized!r}; "
                         f"expected one of {quant.QUANT_SCHEMES} or None")
    dev = resolve_device(device)
    x = np.asarray(vectors, np.float32)
    n = x.shape[0]
    ns = n // num_shards
    if ns * num_shards != n:
        raise ValueError("dataset must split evenly across shards")
    keep = _shards_built(num_shards, shard)
    pq_global = None
    if quantized == "pq":
        if pq_m is None:
            pq_m = quant.default_pq_m(int(x.shape[-1]))
        pq_global = quant.train_pq(x, m=pq_m, codes=pq_codes, iters=pq_iters,
                                   seed=seed, sample=pq_sample, device=dev)

    def codes_of(s, chunk):
        if quantized == "int8":
            c = quant.quantize_int8(chunk, scale_rows=scale_rows, device=dev)
            return c.codes, c.scales
        return pq_global.codes[s * ns:(s + 1) * ns], None

    return _assemble(x, num_shards, keep, metric, M, builder, quantized,
                     scale_rows, codes_of,
                     pq_global.codebooks if pq_global else None, dev)


def reshard_index(index: ShardedIndex, num_shards: int, all_vectors=None, *,
                  M: int | None = None, builder: str = "knng",
                  shard: int | None = None) -> ShardedIndex:
    """Repartition a ``ShardedIndex`` across a new power-of-two shard count,
    on the index's device.

    Shard ``s`` owns global rows ``[s * ns, (s + 1) * ns)``, so this is a
    re-blocking of the stacked rows: global ids never move. Each new
    shard's graph is rebuilt from its float rows with ``builder`` (which,
    like ``M``, must be the original build's), so a round trip (4 -> 8 ->
    4) gives back the original index bit for bit. int8 codes are quantized
    again block by block on the same ``scale_rows`` grid (which must divide
    both shard sizes), giving the re-blocked codes and scales exactly; PQ
    codes are encoded again with the shared codebooks over the whole
    corpus, as the training encoded it.

    ``all_vectors`` is the float corpus, which the caller keeps for a
    quantized index (whose ``vectors`` is None) and for a rank's part.
    ``M`` defaults to half the stored neighbour width (the builder's
    ``M0 = 2 * M``). ``shard`` keeps one part of the target (-1: none),
    which a rank's part of an index over a process group (``total_shards``
    set) must name: every rank keeps the host rows, so rows never cross
    ranks, and the part equals ``local_shard`` of the whole index's
    reshard bit for bit.
    """
    p_old, ns_old = index.num_shards, index.shard_size
    n = p_old * ns_old
    if num_shards & (num_shards - 1) or num_shards < 1:
        raise ValueError(f"num_shards={num_shards} must be a power of two "
                         "(tournament merge)")
    if n % num_shards:
        raise ValueError(f"corpus of {n} rows does not split across "
                         f"{num_shards} shards")
    if index.total_shards and shard is None:
        raise ValueError("a rank's part of an index reshards into its part "
                         "of the target: pass shard=")
    if num_shards == p_old:
        return index
    ns_new = n // num_shards
    if index.scheme == "int8" and (ns_old % index.scale_rows
                                   or ns_new % index.scale_rows):
        raise ValueError(
            f"int8 scale blocks ({index.scale_rows} rows) must divide both "
            f"shard sizes ({ns_old} -> {ns_new}); rebuild instead of "
            "resharding")
    if index.vectors is not None and not index.total_shards:
        flat = index.vectors.reshape(n, -1).cpu().numpy()
    elif all_vectors is not None:
        flat = torch.as_tensor(all_vectors)[:n].cpu().numpy()
    else:
        raise ValueError("resharding a quantized index, or a rank's part, "
                         "needs the float corpus (all_vectors=)")
    _check_builder(builder)
    if M is None:
        M = index.neighbors.shape[-1] // 2
    dev = index.device
    keep = _shards_built(num_shards, shard)
    pq_codes = (quant.pq_encode(flat, index.codebooks)
                if index.scheme == "pq" and keep else None)

    def codes_of(s, chunk):
        if index.scheme == "int8":
            c = quant.quantize_int8(chunk, scale_rows=index.scale_rows,
                                    device=dev)
            return c.codes, c.scales
        return pq_codes[s * ns_new:(s + 1) * ns_new], None

    return _assemble(flat, num_shards, keep, index.metric, M, builder,
                     index.scheme, index.scale_rows, codes_of,
                     index.codebooks, dev)


# ------------------------------------------------------ shard-local beams ----

def spans_ranks(mesh) -> bool:
    """Whether ``mesh`` is cut from a process group of more than one rank
    (its shards, or the group it belongs to, lie in other processes)."""
    world = getattr(mesh, "world", None)
    return world is not None and world.size > 1


def rank_shard(mesh) -> int | None:
    """This rank's shard on ``mesh``: None when one process holds every
    shard, the rank's coordinate over a process group, -1 outside it."""
    if not spans_ranks(mesh):
        return None
    return mesh.rank if mesh.member else -1


def _check_mesh(index: ShardedIndex, mesh, axis: str) -> None:
    if (axis not in mesh.axis_names or mesh.size != index.num_shards
            or mesh.local_size != index.local_shards):
        raise ValueError(f"index of {index.num_shards} shards "
                         f"({index.local_shards} here) on a mesh of "
                         f"{mesh.size} ({mesh.local_size} here) along "
                         f"{mesh.axis_names}, axis {axis!r}")


def _pairs(index: ShardedIndex, qs: torch.Tensor):
    """The stacked graph, each (shard, lane) pair's query and row offset,
    pair ``s * B + b`` for lane b on shard s."""
    corpus, stride = _corpus_parts(index)
    p, dev = index.local_shards, index.device
    graph = make_flat_graph(corpus, index.neighbors.reshape(
        p * index.shard_size, -1), None, 0, index.metric, device=dev)
    B = qs.shape[0]
    offsets = (torch.arange(p, device=dev, dtype=torch.int64)
               * stride).repeat_interleave(B)
    return graph, qs.repeat(p, 1), offsets


def _seed(index: ShardedIndex, graph, qp: torch.Tensor, offsets, capacity):
    """Fresh beam states of the pairs: each queue holds its shard's entry
    point, nothing is visited, no steps taken (``beam_search.init_state``
    at each pair's own entry)."""
    R = qp.shape[0]
    dev = index.device
    entry = index.entries.to(torch.int64).repeat_interleave(
        R // index.local_shards)
    rows = (entry + offsets)[:, None]
    if quant.is_quantized(graph.vectors):
        qprep = quant.prepare_query(graph.vectors, qp, index.metric)
        s0 = quant.score_rows(qprep, graph.vectors, rows, index.metric)[:, 0]
    else:
        s0 = kops.batch_similarity_gather(qp, graph.vectors,
                                          rows.to(torch.int32),
                                          index.metric)[:, 0]
    queue = qmod.make_queue(capacity, (R,), dev)
    queue.ids[:, 0] = entry.to(torch.int32)
    queue.scores[:, 0] = s0
    queue.stable[:, 0] = False
    return bs.SearchState(queue, torch.zeros((R, index.shard_size),
                                             dtype=torch.bool, device=dev),
                          torch.zeros(R, dtype=torch.int32, device=dev))


def _harvest(index: ShardedIndex, queue: qmod.Queue, K: int):
    """Each pair's first K entries with global ids [P, B, K], padded with
    (-1, -inf) past the queue's capacity (P the shards stacked here)."""
    p = index.local_shards
    h = min(K, queue.capacity)
    ids, scores = queue.ids[:, :h], queue.scores[:, :h]
    base = index.bases.to(torch.int64).repeat_interleave(ids.shape[0] // p)
    ids = torch.where(ids >= 0, ids.to(torch.int64) + base[:, None],
                      -1).to(torch.int32)
    if h < K:       # the budget exceeds the shard's own content
        pad = qmod.make_queue(K - h, (ids.shape[0],), ids.device)
        ids = torch.cat([ids, pad.ids], -1)
        scores = torch.cat([scores, pad.scores], -1)
    return ids.reshape(p, -1, K), scores.reshape(p, -1, K)


def _shard_beams(index: ShardedIndex, qs: torch.Tensor, k: int, L: int):
    """Scratch shard-local beam search of every lane on every shard (the
    reference's ``_local_topk`` under ``shard_map``): global ids and scores
    [P, B, k] and the expansion counts [P, B]."""
    graph, qp, offsets = _pairs(index, qs)
    state = _seed(index, graph, qp, offsets, L)
    state = bs.run_search(graph, qp, state, stable_limit=L,
                          row_offset=offsets)
    ids, scores = _harvest(index, state.queue, k)
    return ids, scores, state.steps.reshape(index.local_shards, -1)


def _tournament_merge(ids, scores, mesh):
    """Butterfly merge of the shards' lists [S, B, k]: the global top-k
    after log2(P) rounds. On one device the shards' lists already lie in
    one tensor, so one ``topk_tournament`` call (one launch) runs every
    round, each lane reading its partners' lists itself. Over a process
    group each round exchanges the rank's list with rank ``me ^ stride``
    (ids and score bits in one message) and merges the two runs with one
    ``topk_merge`` launch, as the reference's rounds of ``ppermute``."""
    p = mesh.size
    if p & (p - 1):
        raise ValueError("tournament merge needs power-of-two shards")
    if ids.shape[0] == p:
        return kops.topk_tournament(ids, scores)
    k = ids.shape[-1]
    for r in range(p.bit_length() - 1):
        stride = 1 << r
        wire = torch.cat([ids, scores.view(torch.int32)], -1)
        other = mesh.exchange(wire, lambda c, s=stride: c ^ s)
        ids, scores = kops.topk_merge(ids, scores, other[..., :k],
                                      other[..., k:].view(torch.float32))
    return ids[0], scores[0]


def _allgather_merge(ids, scores, mesh, k: int):
    """Every shard's list gathered, then one (score desc, id asc) sort per
    lane — plain PyTorch, as the reference leaves it to ``jnp.lexsort``."""
    b = ids.shape[1]
    return sort_top(mesh.all_gather(ids, axis=1).reshape(b, -1),
                    mesh.all_gather(scores, axis=1).reshape(b, -1), k)


def _merge(ids, scores, mesh, merge: str, k: int):
    if mesh.size == 1:
        return ids[0], scores[0]
    if merge == "tournament":
        return _tournament_merge(ids, scores, mesh)
    if merge == "allgather":
        return _allgather_merge(ids, scores, mesh, k)
    raise ValueError(f"unknown merge {merge!r}")


def _f32(a, device) -> torch.Tensor:
    """An array, a tensor or a scalar as a float32 tensor on ``device``."""
    return torch.as_tensor(a).to(device, torch.float32).contiguous()


def sharded_topk(index: ShardedIndex, qs, k: int, L: int, mesh,
                 axis: str = "data", merge: str = "tournament",
                 with_expansions: bool = False):
    """Global top-k of queries qs[B, d] over all shards: (ids int32[B, k],
    scores f32[B, k]), plus the per-lane expansion counts summed over the
    shards (int32[B]) with ``with_expansions``.

    The scratch half: every call starts each shard-local beam (capacity
    and stable limit ``L``) at its shard's entry point."""
    _check_mesh(index, mesh, axis)
    qs = _f32(qs, index.device)
    ids, scores, steps = _shard_beams(index, qs, k, L)
    ids, scores = _merge(ids, scores, mesh, merge, k)
    if with_expansions:
        return ids, scores, mesh.psum(steps)
    return ids, scores


# ------------------------------------------------- resumable shard beams ----

class ShardedSearchState(NamedTuple):
    """Per-lane, per-shard beam state carried across budget rounds.

    Lane b's slice on shard s, ``(ids[s, b], scores[s, b], stable[s, b],
    visited[s, b], steps[s, b])``, is a ``beam_search.SearchState`` with
    shard-local ids. Its capacity is fixed (``beam_state_capacity``): each
    rung of the ladder is the same queue under a wider stable limit.
    """
    ids: torch.Tensor      # int32[P, B, C]
    scores: torch.Tensor   # f32[P, B, C]
    stable: torch.Tensor   # bool[P, B, C]
    visited: torch.Tensor  # bool[P, B, Ns]
    steps: torch.Tensor    # int32[P, B]

    @property
    def capacity(self) -> int:
        return self.ids.shape[-1]


def beam_state_capacity(index: ShardedIndex, K_max: int,
                        L_factor: int = 4) -> int:
    """Queue width for resumable beams: wide enough that no rung's beam
    (``K * L_factor``) drops a candidate, or that the whole shard fits."""
    return min(next_pow2(max(int(K_max) * int(L_factor), 1)),
               next_pow2(index.shard_size))


def init_sharded_state(index: ShardedIndex, num_lanes: int, capacity: int,
                       mesh=None, axis: str = "data") -> ShardedSearchState:
    """Empty (all lanes unseeded) state on the index's device."""
    if mesh is not None:
        _check_mesh(index, mesh, axis)
    return _empty_state(index.local_shards, index.shard_size, num_lanes,
                        capacity, index.device)


def _empty_state(p: int, ns: int, num_lanes: int, capacity: int,
                 dev) -> ShardedSearchState:
    q = qmod.make_queue(capacity, (p, num_lanes), dev)
    return ShardedSearchState(
        q.ids, q.scores, q.stable,
        torch.zeros((p, num_lanes, ns), dtype=torch.bool, device=dev),
        torch.zeros((p, num_lanes), dtype=torch.int32, device=dev))


def state_from_host(host: dict, device=None) -> ShardedSearchState:
    """A state on ``device`` (``cuda`` unless given) from a dict of numpy
    leaves under the reference's field names."""
    dev = resolve_device(device)
    dtypes = (torch.int32, torch.float32, torch.bool, torch.bool, torch.int32)
    return ShardedSearchState(*(
        torch.as_tensor(np.array(host[f])).to(dev, dt).contiguous()
        for f, dt in zip(ShardedSearchState._fields, dtypes)))


def migrate_sharded_state(state: ShardedSearchState, num_shards: int,
                          capacity: int | None = None, mesh=None,
                          axis: str = "data",
                          num_lanes: int | None = None,
                          old_mesh=None) -> ShardedSearchState:
    """Re-bucket in-flight per-lane beam state onto a new shard layout, on
    the state's device.

    A queue entry's global id is ``local + s * ns``. Each entry goes to the
    new shard that owns its global id; every (shard, lane) queue is re-sorted
    (score desc, global id asc) — the reference's ``np.lexsort((g, -s))``,
    here three stable sorts, one key each, from the last key to the first,
    with -0.0 sorted as +0.0 as numpy compares them — and each entry lands
    in a slot of its own, so no scatter writes one place twice. The visited
    bits follow their global row. ``steps`` keep each lane's per-shard
    totals: a split shard's count rides on its first child, merged shards
    sum. A target queue narrower than a (shard, lane)'s entries raises
    rather than drop candidates.

    ``num_lanes`` resizes the lane axis: new lanes are empty (unseeded), a
    smaller count keeps lanes ``[:num_lanes]`` and drops the rest.

    Over a process group (``mesh`` the target, ``old_mesh`` the source,
    both cut from one group's first ranks) every rank of the group calls
    it: the old mesh's blocks are gathered over the whole group with one
    ``all_gather`` a leaf (a collective, not point to point: gloo aborts
    on a CUDA tensor sent point to point), a rank outside the old mesh
    sending zeros in its slot, then every rank runs the arithmetic above
    on the whole state and keeps its block of the target (none outside
    it). The bytes gathered are counted in the group mesh's
    ``gathered_bytes``.
    """
    if spans_ranks(mesh):
        return _migrate_across_ranks(state, num_shards, capacity, mesh, axis,
                                     num_lanes, old_mesh)
    ids, scores, stable, visited, steps = state
    p_old, B, C_old = ids.shape
    ns_old = visited.shape[-1]
    n = p_old * ns_old
    if num_shards < 1 or num_shards & (num_shards - 1) or n % num_shards:
        raise ValueError(f"cannot migrate {p_old}x{ns_old} beam state to "
                         f"{num_shards} shards")
    if mesh is not None and (axis not in mesh.axis_names
                             or mesh.size != num_shards):
        raise ValueError(f"{num_shards} shards on a mesh of {mesh.size} "
                         f"along {mesh.axis_names}, axis {axis!r}")
    ns_new = n // num_shards
    C_new = int(capacity or C_old)
    dev = ids.device
    E = p_old * C_old

    # queue entries as global ids, each lane's entries in one row [B, E]
    base = (torch.arange(p_old, device=dev, dtype=torch.int64)
            * ns_old)[:, None, None]
    gids = torch.where(ids >= 0, ids.to(torch.int64) + base, -1)
    gids = gids.transpose(0, 1).reshape(B, E)
    sc = scores.transpose(0, 1).reshape(B, E)
    st = stable.transpose(0, 1).reshape(B, E)
    live = gids >= 0
    shard = torch.where(live, gids // ns_new, num_shards)  # empty: at the end
    order = torch.sort(torch.where(live, gids, n), dim=1, stable=True).indices
    by_score = torch.sort((sc + 0.0).gather(1, order), dim=1,
                          descending=True, stable=True).indices
    order = order.gather(1, by_score)
    by_shard = torch.sort(shard.gather(1, order), dim=1, stable=True)
    order = order.gather(1, by_shard.indices)
    s_sorted = by_shard.values
    bounds = torch.arange(num_shards + 1, device=dev).repeat(B, 1)
    starts = torch.searchsorted(s_sorted, bounds)
    counts = (starts[:, 1:] - starts[:, :-1]).T            # [P_new, B]
    over = (counts > C_new).nonzero()
    if over.numel():
        s, b = (int(v) for v in over[0])
        raise ValueError(
            f"capacity {C_new} cannot hold the {int(counts[s, b])} migrated "
            f"candidates of lane {b} shard {s}; size the target state with "
            "beam_state_capacity")
    pos = (torch.arange(E, device=dev).expand(B, -1)
           - starts.gather(1, s_sorted.clamp(max=num_shards - 1)))
    keep = s_sorted < num_shards
    lane = torch.arange(B, device=dev)[:, None].expand(B, E)
    slot = ((s_sorted * B + lane) * C_new + pos)[keep]
    g = gids.gather(1, order)[keep]
    new = qmod.make_queue(C_new, (num_shards, B), dev)
    new.ids.view(-1)[slot] = (g - s_sorted[keep] * ns_new).to(torch.int32)
    new.scores.view(-1)[slot] = sc.gather(1, order)[keep]
    new.stable.view(-1)[slot] = st.gather(1, order)[keep]

    new_vis = (visited.transpose(0, 1).reshape(B, num_shards, ns_new)
               .transpose(0, 1).contiguous())
    if num_shards >= p_old:
        new_steps = torch.zeros((num_shards, B), dtype=torch.int32,
                                device=dev)
        new_steps[::num_shards // p_old] = steps
    else:
        new_steps = steps.reshape(num_shards, p_old // num_shards, B).sum(
            dim=1, dtype=torch.int32)
    leaves = [new.ids, new.scores, new.stable, new_vis, new_steps]
    B_new = int(num_lanes or B)
    if B_new != B:
        empty = _empty_state(num_shards, ns_new, B_new, C_new, dev)
        keep_b = min(B, B_new)
        for out, leaf in zip(empty, leaves):
            out[:, :keep_b] = leaf[:, :keep_b]
        leaves = list(empty)
    return ShardedSearchState(*leaves)


def _migrate_across_ranks(state: ShardedSearchState, num_shards: int,
                          capacity, mesh, axis: str, num_lanes, old_mesh
                          ) -> ShardedSearchState:
    """``migrate_sharded_state`` over a process group: gather, migrate the
    whole state, keep this rank's block."""
    if old_mesh is None or old_mesh.world is not mesh.world:
        raise ValueError("migrating across ranks needs the old mesh, cut "
                         "from the target's group (old_mesh=)")
    if axis not in mesh.axis_names or mesh.size != num_shards:
        raise ValueError(f"{num_shards} shards on a mesh of {mesh.size} "
                         f"along {mesh.axis_names}, axis {axis!r}")
    world, p_old = mesh.world, old_mesh.size
    whole = []
    for leaf in state:
        block = leaf if leaf.shape[0] else torch.zeros(
            (1, *leaf.shape[1:]), dtype=leaf.dtype, device=leaf.device)
        wire = block.to(torch.uint8) if block.dtype == torch.bool else block
        got = world.all_gather(wire)[:p_old]
        whole.append(got.to(torch.bool) if block.dtype == torch.bool
                     else got)
    new = migrate_sharded_state(ShardedSearchState(*whole), num_shards,
                                capacity, None, axis, num_lanes)
    at = (slice(mesh.rank, mesh.rank + 1) if mesh.member else slice(0, 0))
    return ShardedSearchState(*(leaf[at].contiguous() for leaf in new))


def _resume_beams(index: ShardedIndex, state: ShardedSearchState, qs,
                  lanes: torch.Tensor, fresh: torch.Tensor, K: int, L: int):
    """Seed (``fresh``) or resume each lane of ``lanes`` on every shard, to
    the stable limit ``L`` with a step budget of ``4 L + 64`` on top of its
    steps so far. Returns its shards' top-K [P, g, K] and its new state
    leaves [P, g, ...]."""
    p, g = index.local_shards, lanes.shape[0]
    graph, qp, offsets = _pairs(index, qs)
    cur = [leaf[:, lanes].reshape(p * g, *leaf.shape[2:]) for leaf in state]
    seeded = _seed(index, graph, qp, offsets, state.capacity)
    f = fresh.repeat(p)
    cur = bs.SearchState(
        qmod.Queue(*(torch.where(f[:, None], a, b) for a, b in
                     zip(seeded.queue, cur[:3]))),
        torch.where(f[:, None], seeded.visited, cur[3]),
        torch.where(f, seeded.steps, cur[4]))
    new = bs.resume_search(graph, qp, cur, stable_limit=L,
                           step_budget=4 * int(L) + 64, row_offset=offsets)
    ids, scores = _harvest(index, new.queue, K)
    leaves = (*new.queue, new.visited, new.steps)
    return ids, scores, [a.reshape(p, g, *a.shape[1:]) for a in leaves]


def sharded_topk_resume(index: ShardedIndex, state: ShardedSearchState, qs,
                        lane_idx, fresh, K: int, L: int, mesh,
                        axis: str = "data", merge: str = "tournament"):
    """Resume (or seed, where ``fresh``) the shard-local beams of the lanes
    in ``lane_idx`` until each one's first ``L`` entries are stable, then
    merge each shard's top-``K`` as ``sharded_topk`` does. Returns
    ``(ids[g, K], scores[g, K], new_state)``; lanes outside ``lane_idx``
    keep their state. A freshly seeded lane's round equals ``sharded_topk``
    at the same ``(K, L)``."""
    _check_mesh(index, mesh, axis)
    dev = index.device
    lane_idx = np.asarray(lane_idx, np.int64).reshape(-1)
    fresh = np.broadcast_to(np.asarray(fresh, bool), lane_idx.shape)
    lanes = torch.as_tensor(lane_idx, device=dev)
    ids, scores, leaves = _resume_beams(
        index, state, _f32(qs, dev), lanes,
        torch.as_tensor(fresh.copy(), device=dev), int(K), int(L))
    new_state = []
    for old, new in zip(state, leaves):
        old = old.clone()
        old[:, lanes] = new
        new_state.append(old)
    ids, scores = _merge(ids, scores, mesh, merge, int(K))
    return ids, scores, ShardedSearchState(*new_state)


# --------------------------------------------------------- diversify ----

def _adjacency(vectors, ids, epss, metric: str):
    """Each lane's G^eps over its candidates' rows ``vectors[ids]``."""
    return kops.pairwise_adjacency_batch(vectors, ids, epss, metric)


def _div_astar(scores, adj, k: int, max_expansions: int):
    """div-A* and Theorem 2's minValue per lane, on the host."""
    return _batched_div_astar(scores, adj, k, max_expansions)


def _diversify(vectors, rows, cand_ids, cand_scores, epss, metric: str,
               k: int, K: int, method: str, max_expansions: int):
    """The replicated diversify stage over merged candidates [B, K]: the
    adjacency of each lane's candidate rows ``vectors[rows]``, then greedy
    or div-A* with the Theorem-2 certificate against ``cand_scores[K-1]``.
    Returns ``(ids int32[B, k], scores f32[B, k], certified bool[B])``."""
    valid = cand_ids >= 0
    adj = _adjacency(vectors, rows, epss, metric)
    if method == "greedy":
        sel, count = kops.greedy_diversify_batch(cand_scores, adj, k, valid)
        certified = count >= k
    else:
        sets, _, complete, mv = _div_astar(
            torch.where(valid, cand_scores, NEG_INF), adj, k, max_expansions)
        sel = torch.as_tensor(sets[:, k - 1], device=cand_ids.device)
        s_K = cand_scores[:, K - 1].cpu().numpy()
        certified = torch.as_tensor((mv > s_K) & complete,
                                    device=cand_ids.device)
    picked = sel >= 0
    at = sel.clamp(min=0).long()
    out_ids = torch.where(picked, torch.gather(cand_ids, 1, at), -1)
    out_sc = torch.where(picked, torch.gather(cand_scores, 1, at), 0.0)
    return out_ids.to(torch.int32), out_sc, certified


def _diversify_batch(all_vectors, metric: str, ids, scores, epss, k: int,
                     K: int, method: str, max_expansions: int):
    """Diversify over the global float corpus ``all_vectors`` [N, d]: the
    one stage both the scratch and the resume paths run."""
    return _diversify(all_vectors, ids, ids, scores, epss, metric, k, K,
                      method, max_expansions)


def _diversify_batch_gathered(cand_vecs, metric: str, ids, scores, epss,
                              k: int, K: int, method: str,
                              max_expansions: int):
    """The same stage over pre-gathered candidate rows [B, K, d] (the
    quantized path, whose float corpus stays on the host)."""
    B = ids.shape[0]
    local = torch.arange(B * K, device=ids.device, dtype=torch.int32)
    rows = torch.where(ids >= 0, local.reshape(B, K), -1)
    return _diversify(cand_vecs.reshape(B * K, -1), rows, ids, scores, epss,
                      metric, k, K, method, max_expansions)


def exact_rerank_frontier(all_vectors, qs, ids, metric: str):
    """Exact float rerank of merged frontiers (quantized path).

    Gathers only the candidates' float rows from ``all_vectors`` (a host
    array, or a tensor on any device), rescores them on ``ids``'s device
    and re-sorts (score desc, id asc), as ``index.flat.exact_rerank`` does.
    Returns ``(ids, scores, vecs)`` with ``vecs`` [B, K, d] the candidates'
    float rows in the reranked order, for the adjacency build."""
    dev = ids.device
    if isinstance(all_vectors, torch.Tensor):
        rows = all_vectors[ids.clamp(min=0).to(all_vectors.device).long()]
    else:
        xs = np.asarray(all_vectors, np.float32)
        rows = torch.from_numpy(xs[np.maximum(ids.cpu().numpy(), 0)])
    rows = rows.to(dev, torch.float32)
    ids_r, sc_r, order = rerank_rows(_f32(qs, dev), ids, rows, metric)
    vecs = torch.gather(rows, 1, order[..., None].expand(rows.shape))
    return ids_r, sc_r, vecs


def _stage(index, all_vectors, qs, ids, scores, eps, k: int, K: int,
           method: str, max_expansions: int):
    """Rerank (quantized index) and diversify merged candidates."""
    dev = index.device
    epss = _f32(eps, dev).expand(ids.shape[0]).contiguous()
    if index.scheme is not None:
        ids, scores, vecs = exact_rerank_frontier(all_vectors, qs, ids,
                                                  index.metric)
        out = _diversify_batch_gathered(vecs, index.metric, ids, scores,
                                        epss, k, K, method, max_expansions)
    else:
        out = _diversify_batch(_f32(all_vectors, dev), index.metric, ids,
                               scores, epss, k, K, method, max_expansions)
    return out, ids, scores


def sharded_diverse_search(index: ShardedIndex, all_vectors, qs, k: int, eps,
                           K: int, mesh, axis: str = "data",
                           L_factor: int = 4, merge: str = "tournament",
                           method: str = "div_astar",
                           max_expansions: int = 100_000,
                           with_expansions: bool = False):
    """Distributed diverse search: sharded candidates (K merged, beams of
    width ``K * L_factor``), then the replicated diversify stage.

    Returns (ids[B, k], scores[B, k], certified[B]), plus the per-lane
    shard-expansion totals with ``with_expansions``. ``all_vectors`` [N, d]
    is the float corpus the candidates' rows are read from (pass it on the
    index's device to avoid a copy a call); ``eps`` is a scalar or one per
    query. A quantized index searches and merges compressed scores, then
    reranks the merged frontier in float before diversifying."""
    ids, scores, expansions = sharded_topk(index, qs, K, K * L_factor, mesh,
                                           axis, merge, with_expansions=True)
    out, _, _ = _stage(index, all_vectors, qs, ids, scores, eps, k, K,
                       method, max_expansions)
    if with_expansions:
        return (*out, expansions)
    return out


def sharded_diverse_resume(index: ShardedIndex, all_vectors,
                           state: ShardedSearchState, qs, lane_idx, fresh,
                           k: int, eps, K: int, mesh, axis: str = "data",
                           L_factor: int = 4, merge: str = "tournament",
                           method: str = "div_astar",
                           max_expansions: int = 100_000):
    """One resumable budget round: continue the selected lanes' beams to
    the ``K * L_factor`` stable limit, merge, diversify.

    Returns (ids[g, k], scores[g, k], cand_ids[g, K], cand_scores[g, K],
    certified[g], new_state); the candidate frontier is the reranked one on
    a quantized index. Freshly seeded lanes equal
    ``sharded_diverse_search`` at the same budget."""
    ids, scores, new_state = sharded_topk_resume(
        index, state, qs, lane_idx, fresh, K, K * L_factor, mesh, axis,
        merge)
    (out_ids, out_sc, cert), ids, scores = _stage(
        index, all_vectors, qs, ids, scores, eps, k, K, method,
        max_expansions)
    return out_ids, out_sc, ids, scores, cert, new_state


def sharded_progressive_diverse(index: ShardedIndex, all_vectors, qs, k: int,
                                eps, mesh, axis: str = "data", K0: int = 32,
                                L_factor: int = 4, merge: str = "tournament",
                                max_expansions: int = 100_000,
                                max_rounds: int = 8, resume: str = "beam"):
    """Progressive distributed diverse search: a lockstep wrapper over
    ``ShardedEngine`` (per-lane budgets doubling from ``K0`` until each lane
    certifies, hits the corpus or runs out of rounds).

    Returns numpy (ids[B, k], scores[B, k], certified[B], K_final[B]).
    Under ``resume="beam"`` a lane finished in its first round equals
    ``sharded_diverse_search`` at its ``K_final``; under ``"scratch"``
    every lane does."""
    from repro_torch.core.backend import LaneRequest
    from repro_torch.sharded_search.engine import ShardedEngine

    qs_np = torch.as_tensor(qs).cpu().numpy().astype(np.float32)
    B = qs_np.shape[0]
    eng = ShardedEngine(index, all_vectors, mesh, num_lanes=B, axis=axis,
                        K0=K0, L_factor=L_factor, merge=merge,
                        max_expansions=max_expansions, max_rounds=max_rounds,
                        max_k=k, resume=resume)
    epss = np.broadcast_to(np.asarray(eps, np.float64), (B,))
    for lane in range(B):
        eng.admit(lane, LaneRequest(q=qs_np[lane], k=k, eps=float(epss[lane]),
                                    method="sharded"))
    out_ids = np.full((B, k), -1, np.int32)
    out_sc = np.zeros((B, k), np.float32)
    out_cert = np.zeros(B, bool)
    K_final = np.zeros(B, np.int64)
    while eng.active_count():
        eng.step()
        for lane, res in eng.harvest():
            out_ids[lane], out_sc[lane] = res.ids, res.scores
            out_cert[lane] = res.stats.certified
            K_final[lane] = res.stats.K_final
            eng.recycle(lane)
    return out_ids, out_sc, out_cert, K_final
