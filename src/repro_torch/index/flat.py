"""Exact top-k and the KNN proximity-graph builder (port of ``repro.index.flat``).

``build_knn_graph``: exact top-(3·M0) neighbours of every node by blocked
``torch.matmul`` on the graph's device (a plain product, which the reference
leaves to numpy outside any kernel), Vamana-style alpha pruning vectorized
over blocks of nodes with each node's candidates' own Gram, reverse edges,
then the connectivity repairs. The passes whose outcome depends on order
(reverse edges, component stitching, directed repair) run sequentially on
the host over Python lists, as the reference runs them; the reverse-edge
pass is skipped when no row has a free slot, and stitching first checks
whether the graph is already connected. Ties in the exact top-k follow ``torch.topk``'s
order, so neighbours equal the reference's on tie-free data.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.graph import FlatGraph, make_flat_graph
from repro_torch.core.similarity import pairwise_sim, query_sim, sqrt_rn


# nodes pruned at once: their candidates' Gram is 4096 x 96 x 96 floats
_PRUNE_BLOCK = 4096


def _sims_block(q_block: np.ndarray, x: np.ndarray, metric: str) -> np.ndarray:
    """Host similarities of q_block[m, d] against x[n, d] (numpy, float32)."""
    dots = q_block @ x.T
    if metric == "ip":
        return dots
    if metric == "cos":
        qn = np.maximum(np.linalg.norm(q_block, axis=1, keepdims=True), 1e-12)
        xn = np.maximum(np.linalg.norm(x, axis=1), 1e-12)
        return dots / (qn * xn[None, :])
    if metric == "l2":
        q2 = np.einsum("nd,nd->n", q_block, q_block)[:, None]
        x2 = np.einsum("nd,nd->n", x, x)[None, :]
        return 1.0 - np.sqrt(np.maximum(q2 + x2 - 2.0 * dots, 0.0))
    raise ValueError(metric)


def _tensor(a, dev: torch.device, dtype=torch.float32) -> torch.Tensor:
    """An array or a tensor as a ``dtype`` tensor on ``dev``."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(dev, dtype)


def exact_topk(queries, x, k: int, metric: str, block: int = 256,
               device=None) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k (ids, scores) per query; ties go to the lower id. The
    inputs are arrays or tensors."""
    dev = resolve_device(device)
    qs = torch.atleast_2d(_tensor(queries, dev))
    xt = _tensor(x, dev)
    ids, scores = [], []
    for s in range(0, qs.shape[0], block):
        sims = pairwise_sim(qs[s:s + block], xt, metric)
        top, order = torch.sort(sims, dim=1, descending=True, stable=True)
        ids.append(order[:, :k].to(torch.int32).cpu())
        scores.append(top[:, :k].cpu())
    return torch.cat(ids).numpy(), torch.cat(scores).numpy()


def exact_rerank(queries, cand_ids, x, metric: str,
                 device=None) -> tuple[np.ndarray, np.ndarray]:
    """Exact float rerank of candidate frontiers (the quantized path's
    score-then-verify stage), on ``device`` (``cuda`` unless given).

    ``queries`` f32[B, d], ``cand_ids`` int[B, K] (-1 padded), ``x``
    f32[N, d] the float corpus, as arrays or tensors. Each
    row's valid candidates are re-scored with ``query_sim`` (one fixed
    reduction order, so a row's scores do not depend on the batch) and
    sorted by (score desc, id asc); -1 entries keep score -inf and sink to
    the tail. Returns ``(ids int32[B, K], scores f32[B, K])``."""
    dev = resolve_device(device)
    qs = torch.atleast_2d(_tensor(queries, dev))
    ids = _tensor(cand_ids, dev, torch.int32)
    xt = _tensor(x, dev)
    ids, sims, _ = rerank_rows(qs, ids, xt[ids.clamp(min=0).long()], metric)
    return ids.cpu().numpy(), sims.cpu().numpy()


def rerank_rows(qs: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
                metric: str):
    """``exact_rerank`` of candidates whose float rows are gathered already:
    ``rows`` f32[B, K, d] holds ``x[max(ids, 0)]``. Returns the reranked
    ``(ids, scores)`` and the permutation ``order`` int64[B, K] that took
    each row's candidates there, as tensors on ``ids``'s device."""
    valid = ids >= 0
    sims = query_sim(qs[:, None, :], rows, metric)
    sims = torch.where(valid, sims, float("-inf"))
    by_id = torch.sort(ids, dim=1, stable=True).indices
    by_score = torch.sort(torch.gather(sims, 1, by_id), dim=1,
                          descending=True, stable=True).indices
    order = torch.gather(by_id, 1, by_score)
    return torch.gather(ids, 1, order), torch.gather(sims, 1, order), order


def _norm_terms(x: np.ndarray, metric: str) -> np.ndarray | None:
    """Per-row norm terms of the corpus, computed on the host exactly as
    ``_sims_block`` computes them (squared norms for l2, clamped norms for
    cos), so the device similarities below round as the reference's do."""
    if metric == "l2":
        return np.einsum("nd,nd->n", x, x)
    if metric == "cos":
        return np.maximum(np.linalg.norm(x, axis=1), 1e-12)
    return None


def _sims_rows(xq: torch.Tensor, xt: torch.Tensor, nq, nx,
               metric: str) -> torch.Tensor:
    """``_sims_block`` on the device, from the rows' precomputed norm terms."""
    dots = xq @ xt.transpose(-1, -2)
    if metric == "ip":
        return dots
    if metric == "cos":
        return dots / (nq[..., :, None] * nx[..., None, :])
    if metric == "l2":
        d2 = torch.clamp(nq[..., :, None] + nx[..., None, :] - 2.0 * dots,
                         min=0.0)
        return 1.0 - sqrt_rn(d2)
    raise ValueError(metric)


def _exact_knn(xt: torch.Tensor, norms, overfetch: int, metric: str,
               block: int) -> np.ndarray:
    """Each node's ``overfetch`` most similar other nodes, best first."""
    n = xt.shape[0]
    knn = torch.empty((n, overfetch), dtype=torch.int32)
    for s in range(0, n, block):
        nq = None if norms is None else norms[s:s + block]
        sims = _sims_rows(xt[s:s + block], xt, nq, norms, metric)
        rows = torch.arange(s, min(s + block, n), device=xt.device)
        sims[rows - s, rows] = float("-inf")  # drop self
        knn[s:s + block] = torch.topk(sims, overfetch, dim=1).indices.to(
            torch.int32).cpu()
    return knn.numpy()


def _alpha_prune(xt: torch.Tensor, norms, knn: np.ndarray, M0: int,
                 metric: str, alpha_sim: float, block: int) -> np.ndarray:
    """Per-node alpha pruning, vectorized over blocks of nodes.

    For each node, walk its candidates best first and keep a candidate
    unless some already kept one is at least as similar to it (times
    ``alpha_sim``) as the node is; stop at M0 kept, then top up with the
    skipped candidates in order. The walk is sequential over a node's
    candidates, but independent between nodes, so one step of it runs for
    a whole block of nodes at once from the candidates' own Gram.
    """
    n, C = knn.shape
    width = min(M0, C)
    out = np.full((n, M0), -1, np.int32)
    order_key = torch.arange(C, device=xt.device)
    for s in range(0, n, block):
        cand = torch.as_tensor(knn[s:s + block], device=xt.device).long()
        cv = xt[cand]                                       # [b, C, d]
        nq = nc = None
        if norms is not None:
            nq, nc = norms[s:s + block, None], norms[cand]
        sims_q = _sims_rows(xt[s:s + block, None, :], cv, nq, nc,
                            metric)[:, 0, :]
        gram = _sims_rows(cv, cv, nc, nc, metric) * alpha_sim  # [b, C, C]
        chosen = torch.zeros(cand.shape, dtype=torch.bool, device=xt.device)
        count = torch.zeros(cand.shape[0], dtype=torch.int64, device=xt.device)
        for t in range(C):
            blocked = torch.any(chosen[:, :t] & (gram[:, t, :t]
                                                 >= sims_q[:, t:t + 1]), dim=1)
            take = (count < M0) & ~blocked
            chosen[:, t] = take
            count += take.to(torch.int64)
        # kept candidates first, then the skipped ones, each in walk order
        key = torch.where(chosen, order_key, order_key + C)
        pick = torch.argsort(key, dim=1)[:, :width]
        out[s:s + block, :width] = torch.gather(cand, 1, pick).cpu().numpy()
    return out


def _add_reverse_edges(neighbors: np.ndarray) -> np.ndarray:
    """Reverse edges into free slots (connectivity), in the reference's
    (node, slot) order; edges added early are walked when their row comes
    up, as in the reference. With no free slot anywhere nothing changes."""
    n, M0 = neighbors.shape
    free = (neighbors < 0).sum(axis=1).tolist()
    if not any(free):
        return neighbors
    rows = neighbors.tolist()
    for i in range(n):
        for j in rows[i]:
            if j < 0:
                break
            if free[j] > 0 and i not in rows[j]:
                rows[j][M0 - free[j]] = i
                free[j] -= 1
    return np.asarray(rows, np.int32)


def build_knn_graph(vectors, metric: str = "l2", M: int = 16,
                    alpha_sim: float = 1.0, block: int = 512,
                    device=None) -> FlatGraph:
    """Exact-KNN proximity graph with alpha pruning + reverse edges, built
    on ``device`` (``cuda`` unless given) and returned there."""
    dev = resolve_device(device)
    x = np.asarray(vectors, np.float32)
    xt = torch.as_tensor(x, device=dev)
    n = x.shape[0]
    M0 = 2 * M
    overfetch = min(n - 1, 3 * M0)
    norms = _norm_terms(x, metric)
    if norms is not None:
        norms = torch.as_tensor(norms, device=dev)
    knn = _exact_knn(xt, norms, overfetch, metric, block)
    neighbors = _alpha_prune(xt, norms, knn, M0, metric, alpha_sim,
                             _PRUNE_BLOCK)
    neighbors = _add_reverse_edges(neighbors)

    # medoid entry point
    mean = x.mean(axis=0)
    entry = int(np.argmax(_sims_block(mean[None], x, metric)[0]))

    neighbors = _stitch_components(xt, norms, neighbors, entry, metric)
    neighbors = _directed_repair(xt, norms, neighbors, entry, knn, metric)
    return make_flat_graph(xt, neighbors, None, entry, metric, device=dev)


def _directed_reachable(neighbors: np.ndarray, entry: int,
                        device=None) -> np.ndarray:
    """Nodes reached from ``entry`` along directed edges, breadth first on
    ``device`` (the graph's: the repair runs it every round, and on the
    host it was the 1M build's largest pass; ``tools/torch_smoke_costs.py``
    times the passes). The reached set is the reference's."""
    nb = torch.as_tensor(neighbors, device=device).long()
    reached = torch.zeros(nb.shape[0], dtype=torch.bool, device=nb.device)
    reached[entry] = True
    frontier = torch.tensor([entry], device=nb.device)
    while frontier.numel():
        nxt = nb[frontier].flatten()
        nxt = nxt[nxt >= 0]
        nxt = torch.unique(nxt[~reached[nxt]])
        reached[nxt] = True
        frontier = nxt
    return reached.cpu().numpy()


def _most_similar(xt: torch.Tensor, norms, rows: np.ndarray,
                  among: np.ndarray, metric: str, block: int = 512):
    """For each node in ``rows``: its most similar node in ``among`` (first
    on ties) and that similarity, on the device."""
    dev = xt.device
    among_t = torch.as_tensor(among, device=dev)
    xa = xt[among_t]
    na = None if norms is None else norms[among_t]
    best_j, best_v = [], []
    for s in range(0, rows.size, block):
        r = torch.as_tensor(rows[s:s + block], device=dev)
        sims = _sims_rows(xt[r], xa, None if norms is None else norms[r], na,
                          metric)
        j = torch.argmax(sims, dim=1)
        v = torch.gather(sims, 1, j[:, None])[:, 0]
        best_v.append(v.cpu())
        best_j.append(j.cpu())
    return (among[torch.cat(best_j).numpy()], torch.cat(best_v).numpy())


def _add_in_edges(neighbors: np.ndarray, pairs) -> np.ndarray:
    """Add edge v -> u for each (u, v) in order: into v's first free slot,
    else over slot u % M0; skipped when the edge exists."""
    m0 = neighbors.shape[1]
    rows: dict[int, list] = {}
    for u, v in pairs:
        row = rows.get(v)
        if row is None:
            row = rows[v] = neighbors[v].tolist()
        if u in row:
            continue
        row[row.index(-1) if -1 in row else u % m0] = u
    for v, row in rows.items():
        neighbors[v] = row
    return neighbors


def _directed_repair(xt: torch.Tensor, norms, neighbors: np.ndarray,
                     entry: int, knn: np.ndarray, metric: str,
                     max_rounds: int = 32) -> np.ndarray:
    """Beam search follows directed edges; make every node entry-reachable.

    For each unreached node, add one in-edge from its nearest already
    reached KNN candidate, or, when none is reached, from its most similar
    reached node; repeat until the directed BFS covers the graph. Within a
    round the sources depend only on the reached set, so they are found for
    all unreached nodes at once (on the device); the edges are then added
    in node order, as the reference adds them.
    """
    for _ in range(max_rounds):
        reached = _directed_reachable(neighbors, entry, xt.device)
        missing = np.flatnonzero(~reached)
        if missing.size == 0:
            return neighbors
        cands = knn[missing]
        ok = reached[cands]
        has = ok.any(axis=1)
        src = cands[np.arange(missing.size), ok.argmax(axis=1)]
        if not has.all():
            src[~has] = _most_similar(xt, norms, missing[~has],
                                      np.flatnonzero(reached), metric)[0]
        neighbors = _add_in_edges(neighbors, zip(missing.tolist(),
                                                 src.tolist()))
    return neighbors


def _undirected_connected(neighbors: np.ndarray, device=None) -> bool:
    """Whether the undirected graph over the adjacency is one component:
    breadth first from node 0 on ``device`` over out-edges and in-edges
    (the in-edges grouped by target, CSR)."""
    nb = torch.as_tensor(neighbors, device=device).long()
    n, m0 = nb.shape
    dev = nb.device
    dst = nb.flatten()
    ok = dst >= 0
    src = torch.arange(n, device=dev).repeat_interleave(m0)[ok]
    dst = dst[ok]
    order = torch.argsort(dst)
    rev = src[order]
    indptr = torch.searchsorted(dst[order], torch.arange(n + 1, device=dev))
    seen = torch.zeros(n, dtype=torch.bool, device=dev)
    seen[0] = True
    frontier = torch.zeros(1, dtype=torch.long, device=dev)
    while frontier.numel():
        out = nb[frontier].flatten()
        starts = indptr[frontier]
        lens = indptr[frontier + 1] - starts
        first = torch.cumsum(lens, 0) - lens
        at = torch.arange(int(lens.sum()), device=dev)
        into = rev[torch.repeat_interleave(starts - first, lens) + at]
        nxt = torch.cat([out[out >= 0], into])
        nxt = torch.unique(nxt[~seen[nxt]])
        seen[nxt] = True
        frontier = nxt
    return bool(seen.all())


def _components(neighbors: np.ndarray) -> np.ndarray:
    """Undirected connected components over the adjacency (union-find, the
    reference's edge order and unions: each root is the reference's). A
    node's root is carried along its row, not looked up again per edge."""
    n = neighbors.shape[0]
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, row in enumerate(neighbors.tolist()):
        ri = find(i)
        for j in row:
            if j >= 0:
                rj = find(j)
                if ri != rj:
                    parent[ri] = rj
                    ri = rj
    return np.array([find(i) for i in range(n)])


def _stitch_components(xt: torch.Tensor, norms, neighbors: np.ndarray,
                       entry: int, metric: str,
                       max_rounds: int = 64) -> np.ndarray:
    """Stitch components together through their closest cross-component
    pairs, bidirectionally, until the graph is connected from the entry.
    Each component's closest (member, main) pair — the first maximum in
    (member, main) order — is found on the device."""
    m0 = neighbors.shape[1]
    for _ in range(max_rounds):
        if _undirected_connected(neighbors, xt.device):
            return neighbors
        comp = _components(neighbors)
        main = comp[entry]
        others = np.unique(comp[comp != main])
        in_main = np.flatnonzero(comp == main)
        for c in others:
            members = np.flatnonzero(comp == c)
            partner, sims = _most_similar(xt, norms, members, in_main, metric)
            i = int(np.argmax(sims))
            a, b = int(members[i]), int(partner[i])
            for (u, v) in ((a, b), (b, a)):
                row = neighbors[u]
                slot = np.flatnonzero(row < 0)
                if slot.size:
                    neighbors[u, slot[0]] = v
                else:
                    neighbors[u, m0 - 1] = v  # overwrite weakest slot
    return neighbors
