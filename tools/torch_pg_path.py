#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 14 (the process-group mesh: the sharded
search over gloo ranks sharing the card, data-parallel training of
qwen2-1.5b at full width, NCCL at world size 1), or with ``--phase15`` its
phase 15 (the facade over a process group: writes, an epoch swap, elastic
rescaling and the serve launcher under torchrun, over gloo ranks sharing
the card), or with ``--phase16`` its phase 16 (tensor parallelism on a
model axis and data-parallel MoE: qwen2-1.5b served on (1, 2) and (1, 4)
and trained on (2, 2), moonshot-v1-16b-a3b at 2 layers trained on (2, 1)
and (1, 2) and served on (1, 2); and (d), the ssm, hybrid, encdec and
vlm families on (1, 2): mamba2-370m, whisper-small, recurrentgemma-9b at
one superblock and llama-3.2-vision-90b at 5 layers served, mamba2-370m
and recurrentgemma-9b trained a step, mamba2-370m at 48 layers also in
float32; over gloo ranks sharing the card),
alone on one CUDA card.

Run from the root of a checkout, on a machine with a card:

    python3 tools/torch_pg_path.py [--n 1000000] [--seed 0]
        [--phase15 | --phase16]

It makes phase 4's corpus, queries and eps. For phase 14 it builds phase
6's index of 4 shards on the card (``build_sharded_index``, as phase 6's
facade does) and serves the 64 queries on a 16-lane ``ShardedEngine`` over
a ``LocalMesh`` (phase 6 (d)), then runs phase 14 against them; phase 15
takes the corpus's first ``EL_ROWS`` rows; phase 16 needs no corpus and
builds no kernel. Every gate of the phase runs.
Writes everything to chiprun_out/pg_path.json; the last line is ``OK``.
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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--phase15", action="store_true",
                   help="run phase 15 (the facade over a process group) "
                        "instead of phase 14")
    p.add_argument("--phase16", action="store_true",
                   help="run phase 16 (tensor parallelism and the "
                        "data-parallel MoE) instead of phase 14")
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    import chip_smoke as cs
    from repro_torch import sharded_search as ss
    from repro_torch.compat import make_mesh
    from repro_torch.core import similarity as sim
    from repro_torch.core.backend import LaneRequest
    from repro_torch.kernels import _build

    print(cs.smi_line(), flush=True)
    os.makedirs(cs.OUT, exist_ok=True)
    device = torch.device("cuda")
    report: dict = {}
    if args.phase16:
        try:
            t = time.perf_counter()
            launches = cs.tensor_parallel_path(torch, report, args.seed,
                                               device)
            print(f"phase 16 s {time.perf_counter() - t}", flush=True)
            print(json.dumps(launches), flush=True)
        finally:
            with open(os.path.join(cs.OUT, "pg_path.json"), "w") as f:
                json.dump(report, f, indent=1, default=str)
        print("OK")
        return 0
    _build.build_all()
    allx = cs.deep_like(torch, args.n + 64, cs.D, args.seed, device)
    x = allx[:args.n].contiguous()
    qs_np = allx[args.n:].cpu().numpy()
    del allx
    eps = cs.calibrate_eps(torch, sim, x, args.seed + 1, device)
    if args.phase15:
        rows = x[:cs.EL_ROWS].cpu().numpy()
        del x
        torch.cuda.empty_cache()
        try:
            t = time.perf_counter()
            launches = cs.facade_pg_path(torch, report, rows, qs_np, eps,
                                         args.seed, device)
            print(f"phase 15 s {time.perf_counter() - t}", flush=True)
            print(json.dumps(launches), flush=True)
        finally:
            with open(os.path.join(cs.OUT, "pg_path.json"), "w") as f:
                json.dump(report, f, indent=1, default=str)
        print("OK")
        return 0
    t = time.perf_counter()
    index = ss.build_sharded_index(x.cpu().numpy(), cs.SHARDS, "l2",
                                   M=cs.M_GRAPH, device=device)
    report["build_s"] = time.perf_counter() - t
    mesh = make_mesh((cs.SHARDS,), ("data",), device=device)
    eng = ss.ShardedEngine(index, x, mesh, num_lanes=cs.LANES, K0=cs.K0,
                           L_factor=cs.L_FACTOR, max_rounds=cs.MAX_ROUNDS,
                           max_k=cs.K, resume="beam")
    eng.prewarm()
    served, _ = cs.serve(torch, eng, qs_np, lambda q: LaneRequest(
        q, cs.K, eps, method="sharded"))
    del eng
    try:
        t = time.perf_counter()
        launches = cs.process_group_path(torch, report, index, x, qs_np, eps,
                                         served, args.seed, device)
        print(f"phase 14 s {time.perf_counter() - t}", flush=True)
        print(json.dumps(launches), flush=True)
    finally:
        with open(os.path.join(cs.OUT, "pg_path.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
