#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 9 (the paper's per-query API) alone, at a
chosen query count, on one CUDA card.

Run from the root of a checkout, on a machine with a card:

    python3 tools/torch_per_query_path.py [--q9 8] [--pds-queries 8]

It builds the kernels, runs phase 4 (the 1M-row deep-like corpus, its KNN
graph built on the card, eps at an expected G^eps degree of 100, the
16-lane engine serving 64 queries), then phase 9 over the first ``--q9``
queries (PDS over the first ``--pds-queries``) with every gate of
``chip_smoke.per_query_path``, and the single-lane adjacency and greedy at
the phase's widths (``chip_smoke.time_phase9_shapes``). The defaults (8
and 8) are phase 9 without the cuts ``chip_smoke.py`` makes (``Q9``,
``PDS_QUERIES``). Writes everything to chiprun_out/per_query_path.json;
the last line is ``OK``. About 18 minutes on an H100 at the defaults.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--q9", type=int, default=8)
    p.add_argument("--pds-queries", type=int, default=8)
    p.add_argument("--n", type=int, default=1_000_000)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    import chip_smoke as cs
    from repro_torch.core import similarity as sim
    from repro_torch.kernels import _build, ops

    print(cs.smi_line(), flush=True)
    _build.build_all()
    os.makedirs(cs.OUT, exist_ok=True)
    report: dict = {}
    try:
        _, graph, qs_np, eps, served4 = cs.main_path(
            torch, argparse.Namespace(n=args.n, queries=64, seed=0), report,
            torch.device("cuda"))
        t = time.perf_counter()
        _, hist = cs.per_query_path(torch, report, graph, qs_np, eps,
                                    served4, args.q9, args.pds_queries)
        print(f"phase 9 s {time.perf_counter() - t}", flush=True)
        timings = {"pairwise_adjacency": {}, "greedy_diversify": {}}
        report["path9_shape_times"] = cs.time_phase9_shapes(
            torch, ops, sim, graph.vectors, hist, 400, timings)
    finally:
        with open(os.path.join(cs.OUT, "per_query_path.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
