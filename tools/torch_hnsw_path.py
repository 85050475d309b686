#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 10 (the paper's index, HNSW) alone on one
CUDA card.

Run from the root of a checkout, on a machine with a card:

    python3 tools/torch_hnsw_path.py [--n10 1000] [--seed 0]

It makes phase 4's corpus and held-out queries (the 1M-row deep-like
mixture and its 64 further rows, from ``--seed``) without building phase
4's graph, builds the kernels, and runs ``chip_smoke.hnsw_path`` on the
first ``--n10`` rows with every gate of the phase: the HNSW and KNN
builds, beam recall, the 16-lane engine on both graphs, the per-query API
and the oracle, the HNSW facade with writes and a background rebuild, and
the sharded path. Writes everything to chiprun_out/hnsw_path.json; the last
line is ``OK``.
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
    p.add_argument("--n10", type=int, default=None,
                   help="rows of the phase (chip_smoke.N10 unless given)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n", type=int, default=1_000_000)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    print(cs.smi_line(), flush=True)
    os.makedirs(cs.OUT, exist_ok=True)
    device = torch.device("cuda")
    allx = cs.deep_like(torch, args.n + 64, cs.D, args.seed, device)
    x_np = allx[:args.n10 or cs.N10].cpu().numpy()
    qs_np = allx[args.n:].cpu().numpy()
    del allx
    report: dict = {}
    _build.build_all()
    try:
        t = time.perf_counter()
        launches = cs.hnsw_path(torch, report, x_np, qs_np, args.seed,
                                device)
        print(f"phase 10 s {time.perf_counter() - t}", flush=True)
        print(json.dumps(launches), flush=True)
    finally:
        with open(os.path.join(cs.OUT, "hnsw_path.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
