"""div-A*: exact diverse-set optimization, as a host loop.

Port of ``repro.core.div_astar``: the same depth-first branch-and-bound over
a fixed stack (depth <= k+1 thanks to in-place sibling cursors), candidates
in (score desc, index asc) order, admissible bound = current score + sum of
the next best remaining scores (conflicts ignored). Pruning keeps a state
alive if it could improve the incumbent of ANY size m' <= k, so the optimal
sets of every size 1..k come out (PSS consumes all of them through Theorem 2).

The reference runs this under ``lax.while_loop``; it has no Pallas kernel,
and one lane's steps are strictly sequential. Here it is a Python loop over
one lane's ``(K,)`` scores and ``(K, K)`` adjacency, copied off the device
once per verify group. Every sum is taken in float32 with the same ``cum``
prefix sums, the same bounds and the same step accounting, so ``complete``
and ``expansions`` match the reference step for step. A device version of
div-A* is later work. ``repro.core.div_astar_ref`` (the numpy oracle in the
reference package) is a second check in the tests.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

NEG = np.float32(-np.inf)


class DivAStarResult(NamedTuple):
    best_sets: np.ndarray    # int32[k, k] local indices, -1 padded; row m = size m+1
    best_scores: np.ndarray  # f32[k]
    complete: bool
    expansions: int


def div_astar(scores, adj, k: int, max_expansions: int = 200_000) -> DivAStarResult:
    """scores f32[K] (-inf = invalid), adj bool[K, K] (numpy or CPU tensors)."""
    scores = np.asarray(scores, np.float32)
    adj = np.asarray(adj, bool)
    K = scores.shape[0]
    valid = np.isfinite(scores)
    key = np.where(valid, scores, NEG).astype(np.float32)
    order = np.lexsort((np.arange(K), -key))
    s_arr = key[order]
    with np.errstate(invalid="ignore"):
        cum_arr = np.concatenate([np.zeros(1, np.float32),
                                  np.cumsum(np.where(s_arr > NEG, s_arr, 0),
                                            dtype=np.float32)])
    # adjacency rows in sorted order as int bitmasks (bit j = sorted column j)
    packed = np.packbits(adj[np.ix_(order, order)], axis=1, bitorder="little")
    arow = [int.from_bytes(r.tobytes(), "little") for r in packed]
    s = list(s_arr)
    cum = list(cum_arr)
    n_valid = int(valid.sum())

    t = 0
    cursor = [0] * (k + 1)
    score = [np.float32(0.0)] * (k + 1)
    banned = [0] * (k + 1)
    chosen: list[tuple] = [()] * (k + 1)
    best_scores = [NEG] * k
    best_sets: list[tuple] = [()] * k
    steps = 0
    while t >= 0 and steps < max_expansions:
        cand = cursor[t]
        depth = t
        steps += 1
        if cand >= K or depth >= k:          # pop
            t -= 1
            continue
        cursor[t] = cand + 1                 # advance
        if (banned[depth] >> cand) & 1 or s[cand] <= NEG:
            continue
        new_score = score[depth] + s[cand]
        m = depth + 1
        row = chosen[depth] + (cand,)
        if new_score > best_scores[m - 1]:
            best_scores[m - 1] = new_score
            best_sets[m - 1] = row
        if m >= k:
            continue
        promising = False
        for add in range(1, k - m + 1):     # deeper sizes m2 = m + add
            hi = cand + 1 + add
            if hi > n_valid or hi > K:
                break                        # feasibility only shrinks with add
            if new_score + (cum[hi] - cum[cand + 1]) > best_scores[m + add - 1]:
                promising = True
                break
        if promising:
            t += 1
            cursor[t] = cand + 1
            score[t] = new_score
            banned[t] = banned[depth] | arow[cand] | (1 << cand)
            chosen[t] = row

    sets = np.full((k, k), -1, np.int32)
    for m, row in enumerate(best_sets):
        if row:
            sets[m, : len(row)] = order[list(row)]
    return DivAStarResult(sets, np.asarray(best_scores, np.float32),
                          bool(t < 0), steps)


def prefix_div_astar(ids, scores, adj, k: int, max_expansions: int = 200_000):
    """div-A* over one candidate prefix held as tensors on any device: ids
    int32[K] (-1 = padding, its score masked to -inf), scores f32[K], adj
    bool[K, K], each copied to the host once. Returns ``(result, ids,
    scores)``, the last two as the host arrays the selection is read from."""
    ids, scores, adj = (t.cpu().numpy() for t in (ids, scores, adj))
    res = div_astar(np.where(ids >= 0, scores, NEG), adj, k, max_expansions)
    return res, ids, scores


def optimal_diverse_set(scores, adj, k: int, max_expansions: int = 200_000):
    """Convenience: (ids_local int32[k] (-1 pad), total_score, complete)."""
    res = div_astar(scores, adj, k, max_expansions)
    return res.best_sets[k - 1], res.best_scores[k - 1], res.complete
