"""HNSW proximity-graph builder (port of ``repro.index.hnsw``).

Malkov & Yashunin's graph, the paper's index of choice (§II-A): geometric
level assignment with mL = 1/ln(M), an ef_construction beam search per
insert, heuristic neighbour selection (Alg. 4 of the HNSW paper),
bidirectional links with degree-capped pruning, M0 = 2M at level 0.

This is the offline stage and it has no kernel: every insert depends on
every float comparison of the inserts before it, so the builder keeps the
reference's host arithmetic (float32 numpy scores, ``heapq`` on
``(-s, id)``, stable sorts) and gives its graph bit for bit — ``neighbors``,
``upper`` (``upper[0]`` the top level), ``entry`` and ``levels`` — then
moves the result to ``device`` (``cuda`` unless given) as a ``FlatGraph``.
The one change is in the heuristic selection, which makes all of its
``pair < csim`` comparisons in one array operation and keeps their outcome
as bits, instead of testing the chosen neighbours again at every candidate;
it decides the same way (``_select_neighbors``).

Similarity is higher = more similar for all three metrics.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.graph import FlatGraph, make_flat_graph


def _pairwise(x: np.ndarray, metric: str) -> np.ndarray:
    dots = x @ x.T
    if metric == "ip":
        return dots
    if metric == "cos":
        n = np.maximum(np.sqrt(np.einsum("nd,nd->n", x, x)), 1e-12)
        return dots / (n[:, None] * n[None, :])
    if metric == "l2":
        sq = np.einsum("nd,nd->n", x, x)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * dots, 0.0)
        return 1.0 - np.sqrt(d2)
    raise ValueError(metric)


def _sims(q: np.ndarray, x: np.ndarray, metric: str) -> np.ndarray:
    dots = x @ q
    if metric == "ip":
        return dots
    if metric == "cos":
        qn = max(float(np.sqrt(q @ q)), 1e-12)
        xn = np.maximum(np.sqrt(np.einsum("nd,nd->n", x, x)), 1e-12)
        return dots / (qn * xn)
    if metric == "l2":
        d2 = np.maximum(q @ q + np.einsum("nd,nd->n", x, x) - 2.0 * dots, 0.0)
        return 1.0 - np.sqrt(d2)
    raise ValueError(metric)


@dataclasses.dataclass
class HNSWBuilder:
    vectors: np.ndarray
    metric: str = "l2"
    M: int = 16
    ef_construction: int = 200
    seed: int = 0
    device: object = None

    def __post_init__(self):
        self.vectors = np.asarray(self.vectors, np.float32)
        self.N, self.d = self.vectors.shape
        self.M0 = 2 * self.M
        self.mL = 1.0 / np.log(self.M)
        rng = np.random.default_rng(self.seed)
        self.levels = np.minimum(
            (-np.log(rng.uniform(size=self.N, low=1e-12, high=1.0))
             * self.mL).astype(np.int64), 12)
        # adjacency per level: level -> {node: list of neighbours}
        self.adj: list[dict[int, list[int]]] = [
            {} for _ in range(int(self.levels.max()) + 1)]
        self.entry = -1
        self.max_level = -1

    # -- search-layer (HNSW Alg. 2), numpy + heapq --------------------------
    def _search_layer(self, q: np.ndarray, entry: int, ef: int,
                      level: int) -> tuple[np.ndarray, np.ndarray]:
        adj = self.adj[level]
        visited = {entry}
        e_sim = float(_sims(q, self.vectors[entry][None, :], self.metric)[0])
        cand = [(-e_sim, entry)]       # max-heap on sim
        result = [(e_sim, entry)]      # min-heap on sim, size <= ef
        while cand:
            neg_sim, node = heapq.heappop(cand)
            if -neg_sim < result[0][0] and len(result) >= ef:
                break
            nbrs = [x for x in adj.get(node, []) if x not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            sims = _sims(q, self.vectors[nbrs], self.metric)
            worst = result[0][0]
            for x, s in zip(nbrs, sims.tolist()):
                if len(result) < ef or s > worst:
                    heapq.heappush(cand, (-s, x))
                    heapq.heappush(result, (s, x))
                    if len(result) > ef:
                        heapq.heappop(result)
                    worst = result[0][0]
        result.sort(key=lambda t: (-t[0], t[1]))
        ids = np.array([r[1] for r in result], np.int64)
        ss = np.array([r[0] for r in result], np.float64)
        return ids, ss

    # -- heuristic neighbor selection (HNSW Alg. 4) -------------------------
    def _select_neighbors(self, cand_ids: np.ndarray, cand_sims: np.ndarray,
                          m: int) -> list[int]:
        """Keep a candidate (in the given order) if it is closer to the
        query than to every neighbour kept before it, up to ``m``; backfill
        with the best of the rest.

        The reference tests ``pair[pos, c] < csim`` for every kept c at
        each candidate; here all of those comparisons are made at once,
        column c of them packed into the bits of one integer, and ``ok``
        is the AND of the kept columns: bit pos is set while candidate pos
        passes every test so far (a NaN fails its test, as there)."""
        ids = np.asarray(cand_ids, np.int64).tolist()
        n = len(ids)
        chosen_pos: list[int] = []
        if m > 0 and n:
            chosen_pos.append(0)
        if len(chosen_pos) < m and n > 1:
            pair = _pairwise(self.vectors[ids], self.metric)
            below = pair < np.asarray(cand_sims)[:, None]
            cols = np.packbits(below, axis=0, bitorder="little").T
            ok = int.from_bytes(cols[0].tobytes(), "little") >> 1 << 1
            while len(chosen_pos) < m and ok:
                pos = (ok & -ok).bit_length() - 1
                chosen_pos.append(pos)
                ok &= int.from_bytes(cols[pos].tobytes(), "little")
                ok = ok >> (pos + 1) << (pos + 1)
        chosen = [ids[p] for p in chosen_pos]
        # backfill with remaining best if heuristic under-selects
        if len(chosen) < m:
            seen = set(chosen)
            for cid in ids:
                if cid not in seen:
                    chosen.append(cid)
                    seen.add(cid)
                    if len(chosen) >= m:
                        break
        return chosen

    def _link(self, node: int, nbrs: list[int], level: int):
        adj = self.adj[level]
        cap = self.M0 if level == 0 else self.M
        adj[node] = list(nbrs[:cap])
        for nb in nbrs:
            lst = adj.setdefault(nb, [])
            lst.append(node)
            if len(lst) > cap:
                sims = _sims(self.vectors[nb], self.vectors[lst], self.metric)
                order = np.argsort(-sims, kind="stable")
                sel = self._select_neighbors(
                    np.array(lst)[order], sims[order], cap)
                adj[nb] = sel

    def insert(self, i: int):
        lvl = int(self.levels[i])
        if self.entry < 0:
            self.entry = i
            self.max_level = lvl
            for l in range(lvl + 1):
                self.adj[l][i] = []
            return
        cur = self.entry
        # greedy descent above the node's level
        for l in range(self.max_level, lvl, -1):
            changed = True
            cur_sim = float(_sims(self.vectors[i],
                                  self.vectors[cur][None, :], self.metric)[0])
            while changed:
                changed = False
                nbrs = self.adj[l].get(cur, [])
                if nbrs:
                    sims = _sims(self.vectors[i], self.vectors[nbrs],
                                 self.metric)
                    j = int(np.argmax(sims))
                    if sims[j] > cur_sim:
                        cur, cur_sim, changed = nbrs[j], float(sims[j]), True
        # beam-search insert at each level from min(lvl, max_level) down
        for l in range(min(lvl, self.max_level), -1, -1):
            ids, sims = self._search_layer(self.vectors[i], cur,
                                           self.ef_construction, l)
            m = self.M0 if l == 0 else self.M
            nbrs = self._select_neighbors(ids, sims, m)
            self._link(i, nbrs, l)
            cur = int(ids[0])
        if lvl > self.max_level:
            for l in range(self.max_level + 1, lvl + 1):
                self.adj[l][i] = []
            self.max_level = lvl
            self.entry = i

    def build(self, order: np.ndarray | None = None) -> FlatGraph:
        if order is None:
            order = np.arange(self.N)
        for i in order:
            self.insert(int(i))
        return self.export()

    def export(self) -> FlatGraph:
        """The graph on ``device``: level 0 truncated to M0 neighbours, the
        upper levels to M, ``upper[0]`` the top level (``descend``'s
        order)."""
        nbr0 = np.full((self.N, self.M0), -1, np.int32)
        for node, lst in self.adj[0].items():
            lst = lst[: self.M0]
            nbr0[node, : len(lst)] = lst
        n_up = self.max_level  # levels 1..max_level
        if n_up > 0:
            upper = np.full((n_up, self.N, self.M), -1, np.int32)
            for l in range(1, self.max_level + 1):
                row = self.max_level - l
                for node, lst in self.adj[l].items():
                    lst = lst[: self.M]
                    upper[row, node, : len(lst)] = lst
        else:
            upper = np.zeros((0, self.N, 1), np.int32)
        return make_flat_graph(self.vectors, nbr0, upper, self.entry,
                               self.metric, device=self.device)


def build_hnsw(vectors: np.ndarray, metric: str = "l2", M: int = 16,
               ef_construction: int = 200, seed: int = 0,
               device=None) -> FlatGraph:
    """The HNSW graph of ``vectors`` f32[N, d], built on the host and
    placed on ``device`` (``cuda`` unless given)."""
    return HNSWBuilder(vectors, metric, M, ef_construction, seed,
                       device).build()
