#!/usr/bin/env python3
"""Time the port's HNSW build on the host, with its heuristic selection as
the reference runs it (taken from the reference's source: a loop that
tests every chosen neighbour again at each candidate) and as the port runs
it (``HNSWBuilder._select_neighbors``: all comparisons in one array
operation, kept as bits).

Runs on the CPU; the builder is host numpy either way:

    PYTHONPATH=src python3 tools/torch_hnsw_build_time.py [--n 5000] \\
        [--M 12] [--ef 80] [--d 96]

The rows are the deep-like mixture of ``chip_smoke.py`` (64 Gaussian
centres, noise 0.7), drawn with numpy from ``--seed``. Both builds must
give the same adjacency at every level; each prints its seconds and ms an
insert.
"""
from __future__ import annotations

import argparse
import ast
import os
import sys
import time

import numpy as np

from repro_torch.index import hnsw

REFERENCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src", "repro", "index", "hnsw.py")


def reference_select():
    """The reference's ``HNSWBuilder._select_neighbors`` (a loop that tests
    every chosen neighbour again at each candidate), compiled from its one
    source, ``src/repro/index/hnsw.py``, without importing the JAX
    package; its ``_pairwise`` is the port's, the same formula."""
    with open(REFERENCE) as f:
        tree = ast.parse(f.read(), REFERENCE)
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
               and n.name == "HNSWBuilder")
    fn = next(n for n in cls.body if isinstance(n, ast.FunctionDef)
              and n.name == "_select_neighbors")
    scope = {"np": np, "_pairwise": hnsw._pairwise}
    exec(compile(ast.Module([fn], []), REFERENCE, "exec"), scope)
    return scope["_select_neighbors"]


def rows(n: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(64, d)).astype(np.float32)
    return (centres[rng.integers(0, 64, n)]
            + rng.normal(size=(n, d)).astype(np.float32) * 0.7
            ).astype(np.float32)


def build(x, args, select=None):
    b = hnsw.HNSWBuilder(x, "l2", args.M, args.ef, 0, "cpu")
    if select is not None:
        b._select_neighbors = select.__get__(b)
    t0 = time.perf_counter()
    b.build()
    return b, time.perf_counter() - t0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=5000)
    p.add_argument("--d", type=int, default=96)
    p.add_argument("--M", type=int, default=12)
    p.add_argument("--ef", type=int, default=80)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    x = rows(args.n, args.d, args.seed)
    loop, loop_s = build(x, args, reference_select())
    bits, bits_s = build(x, args)
    if loop.adj != bits.adj or loop.entry != bits.entry:
        print("the two selections give different graphs", file=sys.stderr)
        return 1
    print(f"n={args.n} d={args.d} M={args.M} ef_construction={args.ef}: "
          f"{bits.max_level + 1} levels, same graph")
    for what, s in (("reference's selection loop", loop_s),
                    ("port's packed-bit selection", bits_s)):
        print(f"{what}: {s:.2f} s, {s / args.n * 1e3:.3f} ms an insert")
    return 0


if __name__ == "__main__":
    sys.exit(main())
