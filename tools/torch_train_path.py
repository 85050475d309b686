#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 13 (training: qwen2-1.5b at full width
through ``train.loop.train``, the 4 096-token step and the flash Function's
check, the card against the plain CPU, the loop's contract) alone on one
CUDA card.

Run from the root of a checkout, on a machine with a card:

    python3 tools/torch_train_path.py [--seed 0]

Phase 13 needs no search kernel, so nothing is built. Every gate of the
phase runs. Writes everything to chiprun_out/train_path.json; the last
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
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    import chip_smoke as cs

    print(cs.smi_line(), flush=True)
    os.makedirs(cs.OUT, exist_ok=True)
    report: dict = {}
    try:
        t = time.perf_counter()
        launches = cs.train_path(torch, report, args.seed,
                                 torch.device("cuda"))
        print(f"phase 13 s {time.perf_counter() - t}", flush=True)
        print(json.dumps(launches), flush=True)
    finally:
        with open(os.path.join(cs.OUT, "train_path.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
