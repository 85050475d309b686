#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 4 (the PSS engine) and phase 11 (the RAG
serving path at qwen2-1.5b's full width) alone on one CUDA card.

Run from the root of a checkout, on a machine with a card:

    python3 tools/torch_rag_path.py [--n 1000000] [--seed 0]

It builds the kernels, runs ``chip_smoke.main_path`` (phase 4's graph,
eps, 64 served queries and its checks) and then ``chip_smoke.rag_path``
on its graph, eps, queries and served results, with every gate of phase
11: retrieval equal to phase 4's served results, decode against the
forward pass at full width, the card against the plain CPU at 2 layers.
``--n`` below 1M makes a smaller corpus and a quicker graph build. Writes
everything to chiprun_out/rag_path.json; the last line is ``OK``.
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
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--queries", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
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
    report: dict = {}
    _build.build_all()
    try:
        t = time.perf_counter()
        _, graph, qs_np, eps, served4 = cs.main_path(torch, args, report,
                                                     device)
        print(f"phase 4 s {time.perf_counter() - t}", flush=True)
        t = time.perf_counter()
        launches = cs.rag_path(torch, report, graph, qs_np, eps, served4,
                               args.seed, device)
        print(f"phase 11 s {time.perf_counter() - t}", flush=True)
        print(json.dumps(launches), flush=True)
    finally:
        with open(os.path.join(cs.OUT, "rag_path.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
