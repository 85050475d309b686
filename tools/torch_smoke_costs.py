#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s set-up time goes, on one CUDA card: the 1M-row
KNN graph build by pass, and the ways to read a profile.

Run from the root of a checkout, on a machine with a card:

    python3 tools/torch_smoke_costs.py [--n 1000000] [--seed 0]

It builds phase 4's graph (``index.flat.build_knn_graph`` over the
seeded deep-like corpus) with each pass and helper timed (seconds summed
over calls, and the call counts), then profiles one lockstep
``batch_pss`` of 16 queries (device activity only) and reads the
device events three ways: ``prof.events()``, the exported chrome trace
and the kineto events (``chip_smoke.device_events``), printing each
one's seconds, event count and summed duration, which must agree.
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
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.core import batch_progressive as tbp
    from repro_torch.core import similarity as sim
    from repro_torch.index import flat
    from repro_torch.kernels import _build

    print(cs.smi_line(), flush=True)
    _build.build_all()
    device = torch.device("cuda")
    allx = cs.deep_like(torch, args.n + 16, cs.D, args.seed, device)
    x_np, qs = allx[:args.n].cpu().numpy(), allx[args.n:].cpu().numpy()
    timer = cs.StageTimer(torch)
    for attr in ("_exact_knn", "_alpha_prune", "_add_reverse_edges",
                 "_stitch_components", "_components", "_directed_repair",
                 "_directed_reachable", "_add_in_edges", "_most_similar"):
        timer.wrap(flat, attr, attr.lstrip("_"))
    t = time.perf_counter()
    graph = flat.build_knn_graph(x_np, "l2", M=cs.M_GRAPH, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    timer.restore()
    print(f"build {build_s:.1f} s (seconds, calls): " + json.dumps(
        {k: (round(v, 2), timer.calls[k]) for k, v in timer.seconds.items()}),
        flush=True)

    eps = cs.calibrate_eps(torch, sim, graph.vectors, args.seed + 1, device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tbp.batch_pss(graph, qs, cs.K, eps, ef=cs.EF)
        torch.cuda.synchronize()
    path = os.path.join(HERE, "build", "smoke_costs_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def from_trace():
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        return [(e["name"], float(e.get("dur", 0.0))) for e in events
                if e.get("ph") == "X" and e.get("cat") in (
                    "kernel", "gpu_memcpy", "gpu_memset")]

    def from_events():
        return [(e.name, e.device_time_total) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    for name, read in (("kineto events", lambda: cs.device_events(torch,
                                                                 prof)),
                       ("chrome trace", from_trace),
                       ("prof.events()", from_events)):
        t = time.perf_counter()
        events = read()
        print(f"{name}: {time.perf_counter() - t:.2f} s, {len(events)} "
              f"events, {sum(d for _, d in events):.1f} us", flush=True)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
