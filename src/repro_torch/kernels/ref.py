"""Plain PyTorch versions of the port's kernels: the port's oracle.

Port of ``repro.kernels.ref``, composed as the reference composes each
function. Each takes optional leading lane axes where the reference is
vmapped. The CUDA kernels are held against these on the card; on a CPU
tensor ``kernels.ops`` runs these and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch import quant
from repro_torch.core.similarity import pairwise_sim, query_sim


def batch_similarity(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """Scores of rows of x[n, d] against query q[d] -> f32[n]; for q[B, d],
    each lane's ``query_sim`` in turn -> f32[B, n] (the reference vmaps it)."""
    if q.dim() == 1:
        return query_sim(q, x, metric)
    return torch.stack([query_sim(qi, x, metric) for qi in q])


def batch_similarity_many(qs: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """Scores of rows of x[n, d] against queries qs[b, d] -> f32[b, n]."""
    return pairwise_sim(qs, x, metric)


def batch_similarity_gather(qs: torch.Tensor, x: torch.Tensor,
                            ids: torch.Tensor, metric: str) -> torch.Tensor:
    """scores[b, m] = query_sim(qs[b], x[max(ids[b, m], 0)]) -> f32[B, M]:
    the burst's per-lane scoring of gathered neighbour rows."""
    return query_sim(qs[:, None, :], x[ids.clamp(min=0).long()], metric)


def int8_dot(q_codes: torch.Tensor, x_codes: torch.Tensor) -> torch.Tensor:
    """Exact dots int32[b, n] of int8 q_codes[b, d] and x_codes[n, d].

    The product is taken in float64, which is exact (|dot| <= 127^2 * d <
    2^53) and runs on the CPU and the card alike (the card has no int32
    matmul)."""
    return (q_codes.to(torch.float64) @ x_codes.to(torch.float64).T).to(
        torch.int32)


def int8_similarity_many(qs: torch.Tensor, corpus: quant.Int8Corpus,
                         metric: str) -> torch.Tensor:
    """Quantized scores f32[b, n] of an int8 corpus against float queries
    qs[b, d]: exact integer dots, then the shared float postprocess."""
    q_codes, q_scales = quant.quantize_queries(qs)
    dots = int8_dot(q_codes, corpus.codes)
    return quant.int8_score_from_dots(dots, q_codes, q_scales, corpus, metric)


def pq_similarity_many(qs: torch.Tensor, corpus: quant.PQCorpus,
                       metric: str) -> torch.Tensor:
    """Quantized scores f32[b, n] of a PQ corpus against float queries
    qs[b, d]: LUT sums added subspace by subspace, then the shared
    postprocess (only cos reads the centroid norms' sums)."""
    T, S, qn = quant.pq_luts_many(qs, corpus.codebooks, metric)
    sumT = quant.pq_lut_sum(T, corpus.codes)
    sumS = (quant.pq_lut_sum(S, corpus.codes)[None, :] if metric == "cos"
            else None)
    return quant.pq_postprocess(sumT, sumS, qn[:, None], metric)


def pairwise_adjacency(x: torch.Tensor, eps, metric: str,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """Diversity-graph adjacency (paper Def. 2): A[i, j] = sim(x_i, x_j) > eps.

    ``x`` [..., K, d]; ``eps`` a scalar or a tensor broadcasting against
    [..., K, K]. Diagonal is False; ``valid`` [..., K] masks padding rows.
    """
    return strip_adjacency(pairwise_sim(x, x, metric) > eps, valid)


def strip_adjacency(raw: torch.Tensor,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """A thresholded Gram [..., K, K] as an adjacency: no diagonal, and no
    edge at a padding row or column (``valid`` [..., K] False)."""
    k = raw.shape[-1]
    adj = raw.to(torch.bool) & ~torch.eye(k, dtype=torch.bool, device=raw.device)
    if valid is not None:
        adj = adj & valid[..., :, None] & valid[..., None, :]
    return adj


def sort_top(ids: torch.Tensor, scores: torch.Tensor, L: int):
    """The first ``L`` entries of each row of (ids, scores) [..., n] in
    (score desc, id asc) order, ties on both keys in row order: the
    reference's ``jnp.lexsort((ids, -scores))``, taken as two stable sorts,
    id first. The sort key is ``scores + 0.0``, so -0.0 and +0.0 tie on any
    device (a radix sort would order their bit patterns); the scores
    returned are the inputs' own."""
    o1 = torch.sort(ids, dim=-1, stable=True).indices
    key = torch.gather(scores + 0.0, -1, o1)
    o2 = torch.sort(key, dim=-1, descending=True, stable=True).indices
    order = torch.gather(o1, -1, o2)[..., :L]
    return torch.gather(ids, -1, order), torch.gather(scores, -1, order)


def topk_merge(ids_a: torch.Tensor, scores_a: torch.Tensor,
               ids_b: torch.Tensor, scores_b: torch.Tensor):
    """Merge two descending-sorted (ids, scores) runs [..., L] and keep the
    top L under (score desc, id asc), ties on both keys run a first: the
    tournament-merge primitive of the sharded search."""
    return sort_top(torch.cat([ids_a, ids_b], -1),
                    torch.cat([scores_a, scores_b], -1), ids_a.shape[-1])


def topk_tournament(ids: torch.Tensor, scores: torch.Tensor):
    """The sharded search's tournament over the shards' runs [P, B, L]
    (P a power of two): log2(P) butterfly rounds of ``topk_merge``, shard s
    merging its list with shard s ^ 2^r's in round r; shard 0's rows
    [B, L]."""
    p = ids.shape[0]
    for r in range(p.bit_length() - 1):
        other = torch.arange(p, device=ids.device) ^ (1 << r)
        ids, scores = topk_merge(ids, scores, ids[other], scores[other])
    return ids[0], scores[0]


def greedy_diversify(scores: torch.Tensor, adj: torch.Tensor, k: int,
                     valid: torch.Tensor | None = None):
    """Greedy diverse selection (paper §II-B-2) over a scored candidate tile.

    scores [..., K], adj bool [..., K, K]. At each of k steps pick the
    highest scoring non-banned candidate (lowest index on ties), then ban its
    diversity-graph neighbours. Returns (sel int32[..., k] local indices,
    -1 padded; count int32[...]).
    """
    K = scores.shape[-1]
    ar = torch.arange(K, device=scores.device)
    banned = (torch.zeros_like(scores, dtype=torch.bool) if valid is None
              else ~valid)
    count = torch.zeros(scores.shape[:-1], dtype=torch.int32,
                        device=scores.device)
    picks = []
    for _ in range(k):
        avail = torch.where(banned, float("-inf"), scores)
        j = torch.argmax(avail, dim=-1, keepdim=True)
        ok = (~torch.gather(banned, -1, j)
              & torch.isfinite(torch.gather(avail, -1, j)))[..., 0]
        row = torch.gather(adj, -2, j[..., None].expand(*j.shape[:-1], 1, K))
        new_banned = banned | row[..., 0, :] | (ar == j)
        banned = torch.where(ok[..., None], new_banned, banned)
        picks.append(torch.where(ok, j[..., 0], -1).to(torch.int32))
        count = count + ok.to(torch.int32)
    sel = (torch.stack(picks, -1) if picks else
           torch.empty((*scores.shape[:-1], 0), dtype=torch.int32,
                       device=scores.device))
    return sel, count


def fused_round(vectors: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor,
                Ks: torch.Tensor, eps: torch.Tensor, k: int, metric: str):
    """Every lane's fused progressive-round stage (semantic ground truth).

    ``ids``/``scores`` [B, W] are raw sorted queue prefix rows (-1 / -inf
    sentinels), ``Ks`` [B] each lane's candidate budget (positions >= K are
    masked off), ``eps`` [B] each lane's threshold. Composes prefix masking,
    candidate gather, eps-adjacency, greedy selection and output extraction.

    Returns ``(sel_ids int32[B, k] global ids -1-padded, sel_scores f32[B, k]
    zero-padded, count int32[B], cert f32[B, 2] = (total, s_K))``.
    """
    ids_m, scores_m = mask_prefix(ids, scores, Ks)
    valid = ids_m >= 0
    x = vectors[ids_m.clamp(min=0).long()]
    adj = pairwise_adjacency(x, eps[:, None, None], metric, valid)
    sel, count = greedy_diversify(scores_m, adj, k, valid)
    sel_ids, sel_scores = extract_round(sel, ids_m, scores_m)
    return sel_ids, sel_scores, count, certificate(sel_scores, ids_m, scores_m)


def mask_prefix(ids: torch.Tensor, scores: torch.Tensor, Ks: torch.Tensor):
    """Queue prefix rows [B, W] cut to each lane's budget Ks [B]: positions
    >= Ks[b] become the id=-1 / -inf sentinels."""
    keep = torch.arange(ids.shape[-1], device=ids.device)[None, :] < Ks[:, None]
    return torch.where(keep, ids, -1), torch.where(keep, scores, float("-inf"))


def extract_round(sel: torch.Tensor, ids_m: torch.Tensor,
                  scores_m: torch.Tensor):
    """Global ids and scores of the picks (-1 / 0 where no pick)."""
    picked = sel >= 0
    gidx = sel.clamp(min=0).long()
    sel_ids = torch.where(picked, torch.gather(ids_m, 1, gidx), -1)
    sel_scores = torch.where(picked, torch.gather(scores_m, 1, gidx), 0.0)
    return sel_ids.to(torch.int32), sel_scores.to(torch.float32)


def certificate(sel_scores: torch.Tensor, ids_m: torch.Tensor,
                scores_m: torch.Tensor) -> torch.Tensor:
    """Theorem-2 inputs per lane: (total of the picked scores, s_K the worst
    kept candidate score, -inf for an empty prefix) -> f32[B, 2]. The total
    is summed in pick order, one float32 add at a time (the order of XLA's
    CPU reduce at these k, and of the CUDA kernel), so a lane's certificate
    compares the same bits on every rung."""
    valid = ids_m >= 0
    total = torch.zeros(sel_scores.shape[:-1], dtype=torch.float32,
                        device=sel_scores.device)
    for j in range(sel_scores.shape[-1]):
        total = total + sel_scores[..., j]
    s_K = torch.min(torch.where(valid, scores_m, float("inf")), dim=1).values
    s_K = torch.where(valid.any(dim=1), s_K, float("-inf"))
    return torch.stack([total, s_K], dim=1)
