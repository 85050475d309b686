"""Public kernel entry points with backend dispatch (port of ``repro.kernels.ops``).

impl resolution, at call time:
  * "auto" (default): the CUDA kernel when the tensors lie on a CUDA device,
    the plain PyTorch oracle otherwise.
  * "cuda": the hand-written CUDA kernel; raises on a CPU tensor.
  * "ref": the plain PyTorch oracle (``kernels/ref.py``) on any device.

Nothing falls back quietly: a kernel that fails to build or launch raises.
The ops come in the batched forms their callers use: the engine's lane
batches, ``quantized_similarity_many`` for compressed corpora, and
``topk_merge`` over the rows of a tournament round and ``topk_tournament``
over a whole tournament. The single-lane ``pairwise_adjacency`` (the
Theorem-2 audit's, the per-query drivers' and the oracle's) and
``greedy_diversify`` (PGS's and the Greedy baseline's) are one launch each
of the batched adjacency and greedy kernels at B = 1.
"""
from __future__ import annotations

import torch

from repro_torch import quant as _quant
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.batch_similarity import sim_gather_cuda, sim_many_cuda
from repro_torch.kernels.fused_round import fused_round_cuda
from repro_torch.kernels.greedy_diversify import greedy_cuda
from repro_torch.kernels.int8_similarity import int8_dot_cuda
from repro_torch.kernels.pairwise_adjacency import adjacency_cuda
from repro_torch.kernels.pq_lut_similarity import pq_lut_sum_cuda
from repro_torch.kernels.topk_merge import (topk_merge_cuda,
                                             topk_tournament_cuda)

_DEFAULT_IMPL = None  # overridable via set_default_impl
_IMPLS = ("auto", "ref", "cuda")


def set_default_impl(impl: str | None) -> None:
    """Set the process-wide default backend (None restores "auto")."""
    if impl is not None and impl not in _IMPLS:
        raise ValueError(
            f"unknown kernel impl {impl!r}; expected one of {_IMPLS} or None")
    global _DEFAULT_IMPL
    _DEFAULT_IMPL = impl


def resolve(impl: str | None, t: torch.Tensor) -> str:
    """The rung an op runs on for tensor ``t``: "ref" or "cuda"."""
    if impl is None:
        impl = _DEFAULT_IMPL or "auto"
    if impl not in _IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected one of {_IMPLS}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "ref"
    return impl


#: every kernel wrapper, by the name its launches are kept under
KERNELS = {"batch_similarity_many": sim_many_cuda,
           "batch_similarity_gather": sim_gather_cuda,
           "pairwise_adjacency": adjacency_cuda,
           "greedy_diversify": greedy_cuda,
           "fused_round": fused_round_cuda,
           "int8_dot": int8_dot_cuda,
           "pq_lut_sum": pq_lut_sum_cuda,
           "topk_merge": topk_merge_cuda}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel wrapper since the last ``reset_launch_counts``."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def batch_similarity(q: torch.Tensor, x: torch.Tensor, metric: str,
                     impl: str | None = None) -> torch.Tensor:
    """sim(q[d], x[n, d]) -> f32[n]; q[B, d] scores each lane's query in
    turn -> f32[B, n] (the reduce form, batch-invariant on both rungs)."""
    if resolve(impl, x) == "ref":
        return _ref.batch_similarity(q, x, metric)
    out = sim_many_cuda(_f32(q.reshape(-1, q.shape[-1])), _f32(x), metric)
    return out[0] if q.dim() == 1 else out


def batch_similarity_many(qs: torch.Tensor, x: torch.Tensor, metric: str,
                          impl: str | None = None) -> torch.Tensor:
    """sim(qs[b, d], x[n, d]) -> f32[b, n]."""
    if resolve(impl, x) == "ref":
        return _ref.batch_similarity_many(qs, x, metric)
    return sim_many_cuda(_f32(qs), _f32(x), metric)


def batch_similarity_gather(qs: torch.Tensor, x: torch.Tensor,
                            ids: torch.Tensor, metric: str,
                            impl: str | None = None) -> torch.Tensor:
    """sim(qs[b], x[max(ids[b, m], 0)]) -> f32[B, M]: each lane's query
    against its own gathered rows (the burst's neighbour scoring)."""
    if resolve(impl, x) == "ref":
        return _ref.batch_similarity_gather(qs, x, ids, metric)
    return sim_gather_cuda(_f32(qs), _f32(x), _i32(ids), metric)


def quantized_similarity_many(qs: torch.Tensor, corpus, metric: str,
                              impl: str | None = None) -> torch.Tensor:
    """sim(qs[b, d], compressed corpus[n]) -> f32[b, n].

    ``corpus`` is a ``quant.Int8Corpus`` (exact int8 dots, ``int8_dot``) or
    a ``quant.PQCorpus`` (LUT sums over the query tables, and for cos over
    the centroid norms too, ``pq_lut_sum``). Both rungs share the float
    arithmetic around the kernel, so they agree bit for bit."""
    if isinstance(corpus, _quant.Int8Corpus):
        if resolve(impl, corpus.codes) == "ref":
            return _ref.int8_similarity_many(qs, corpus, metric)
        q_codes, q_scales = _quant.quantize_queries(qs)
        dots = int8_dot_cuda(q_codes.contiguous(), corpus.codes.contiguous())
        return _quant.int8_score_from_dots(dots, q_codes, q_scales, corpus,
                                           metric)
    if isinstance(corpus, _quant.PQCorpus):
        if resolve(impl, corpus.codes) == "ref":
            return _ref.pq_similarity_many(qs, corpus, metric)
        T, S, qn = _quant.pq_luts_many(qs, corpus.codebooks, metric)
        codes = corpus.codes.contiguous()
        sumT = pq_lut_sum_cuda(T.contiguous(), codes)
        sumS = (pq_lut_sum_cuda(S[None].contiguous(), codes)
                if metric == "cos" else None)
        return _quant.pq_postprocess(sumT, sumS, qn[:, None], metric)
    raise TypeError("quantized_similarity_many needs a quantized corpus, "
                    f"got {type(corpus).__name__}")


def pairwise_adjacency_batch(vectors: torch.Tensor, ids: torch.Tensor, eps,
                             metric: str, impl: str | None = None) -> torch.Tensor:
    """Per-lane G^eps adjacency bool[G, W, W] among each lane's candidate
    ids[G, W] (-1 = padding, masked out; no diagonal); ``eps`` f32[G]."""
    eps = torch.as_tensor(eps, dtype=torch.float32, device=vectors.device)
    eps = eps.expand(ids.shape[0]).contiguous()
    if resolve(impl, vectors) == "ref":
        x = vectors[ids.clamp(min=0).long()]
        return _ref.pairwise_adjacency(x, eps[:, None, None], metric,
                                       ids >= 0)
    return adjacency_cuda(_f32(vectors), _i32(ids), eps, metric)


def pairwise_adjacency(x: torch.Tensor, eps, metric: str,
                       valid: torch.Tensor | None = None,
                       impl: str | None = None) -> torch.Tensor:
    """Diversity-graph adjacency bool[K, K] of rows x[K, d] (no diagonal;
    rows where ``valid`` is False are padding, masked out). On the kernel
    rung: one launch of the batched adjacency kernel, one lane."""
    if resolve(impl, x) == "ref":
        return _ref.pairwise_adjacency(x, eps, metric, valid)
    ids = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    if valid is not None:
        ids = torch.where(valid.to(x.device), ids, -1)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=x.device)
    return adjacency_cuda(_f32(x), ids[None].contiguous(), eps.reshape(1),
                          metric)[0]


def greedy_diversify(scores: torch.Tensor, adj: torch.Tensor, k: int,
                     valid: torch.Tensor | None = None,
                     impl: str | None = None):
    """Greedy diverse selection over one lane: scores (K,), adj (K, K),
    valid (K,) or None -> (sel int32[k] local idx -1-padded, count int32).
    On the kernel rung: one launch of the batched greedy kernel, one lane."""
    if resolve(impl, scores) == "ref":
        return _ref.greedy_diversify(scores, adj, k, valid)
    s = scores if valid is None else torch.where(valid, scores, float("-inf"))
    sel = greedy_cuda(_f32(s)[None], adj[None].contiguous(), k)[0]
    return sel, torch.sum(sel >= 0).to(torch.int32)


def greedy_diversify_batch(scores: torch.Tensor, adj: torch.Tensor, k: int,
                           valid: torch.Tensor | None = None,
                           impl: str | None = None):
    """Batched greedy selection. scores (B, K), adj (B, K, K), valid (B, K)
    or None. Returns (sel int32[B, k] local idx -1-padded, count int32[B])."""
    s = scores if valid is None else torch.where(valid, scores, float("-inf"))
    if resolve(impl, scores) == "ref":
        return _ref.greedy_diversify(s, adj, k)
    sel = greedy_cuda(_f32(s), adj.contiguous(), k)
    return sel, torch.sum(sel >= 0, dim=1).to(torch.int32)


def fused_round_batch(vectors: torch.Tensor, ids, scores, Ks, eps, k: int,
                      metric: str, impl: str | None = None):
    """One fused progressive round over a lane batch.

    vectors (n, d) corpus, ids int32 (B, W) raw sorted queue prefixes (-1
    sentinels), scores f32 (B, W) (-inf sentinels), Ks (B,) per-lane
    candidate budgets, eps f32 (B,) per-lane thresholds.

    Returns ``(sel_ids int32[B, k] global ids -1-padded, sel_scores f32[B, k]
    zero-padded, count int32[B], cert f32[B, 2] = (total, s_K))``. On the
    kernel rung one launch writes all four, the certificate's total summed
    in pick order as the plain version sums it.
    """
    dev = vectors.device
    ids = torch.as_tensor(ids, device=dev).to(torch.int32)
    scores = torch.as_tensor(scores, device=dev).to(torch.float32)
    Ks = torch.as_tensor(Ks, device=dev).to(torch.int32)
    eps = torch.as_tensor(eps, device=dev).to(torch.float32)
    if resolve(impl, vectors) == "ref":
        return _ref.fused_round(vectors, ids, scores, Ks, eps, k, metric)
    return fused_round_cuda(_f32(vectors), ids.contiguous(),
                            scores.contiguous(), Ks.contiguous(),
                            eps.contiguous(), k, metric)


def topk_merge(ids_a: torch.Tensor, scores_a: torch.Tensor,
               ids_b: torch.Tensor, scores_b: torch.Tensor,
               impl: str | None = None):
    """Merge two runs [..., L] sorted by (score desc, id asc), row by row,
    and keep the top L of each: -> (ids int32[..., L], scores f32[..., L]).
    On the kernel rung one launch merges every row."""
    if resolve(impl, scores_a) == "ref":
        return _ref.topk_merge(ids_a, scores_a, ids_b, scores_b)
    lead, L = ids_a.shape[:-1], ids_a.shape[-1]
    ids, scores = topk_merge_cuda(*(t.reshape(-1, L).contiguous() for t in (
        _i32(ids_a), _f32(scores_a), _i32(ids_b), _f32(scores_b))))
    return ids.reshape(*lead, L), scores.reshape(*lead, L)


def topk_tournament(ids: torch.Tensor, scores: torch.Tensor,
                    impl: str | None = None):
    """The sharded search's tournament over the shards' runs [P, B, L],
    each sorted by (score desc, id asc), P a power of two >= 2: the [B, L]
    rows shard 0 holds after log2(P) butterfly rounds of ``topk_merge``
    -> (ids int32[B, L], scores f32[B, L]). On the kernel rung one launch
    runs every round; its launches count under ``topk_merge``."""
    if ids.dim() != 3 or scores.shape != ids.shape:
        raise ValueError("topk_tournament takes ids and scores [P, B, L], "
                         f"got {tuple(ids.shape)} and {tuple(scores.shape)}")
    p = ids.shape[0]
    if p < 2 or p & (p - 1):
        raise ValueError(f"topk_tournament needs a power of two >= 2 of "
                         f"runs, got P = {p}")
    if resolve(impl, scores) == "ref":
        return _ref.topk_tournament(ids, scores)
    return topk_tournament_cuda(_i32(ids), _f32(scores))
