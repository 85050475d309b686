#!/usr/bin/env python3
"""Time two builds of the similarity kernels on one CUDA card, in turns.

Run from the root of a checkout, on a machine with a card:

    mkdir -p build/before
    git show <commit>:src/repro_torch/kernels/csrc/batch_similarity.cu \\
        > build/before/batch_similarity.cu
    python3 tools/torch_similarity_ab.py build/before/batch_similarity.cu

It compiles the given source (against this checkout's ``csrc/sim.cuh``)
beside the checkout's own ``csrc/batch_similarity.cu``, both with the flags
of ``repro_torch.kernels._build``, and holds them to the same bits at each
shape. Then it times both, before / after / after / before: ``sim_many`` at
16 queries x 1M x 96 (l2) and ``sim_gather`` at 16 x 32 and 64 x 32 rows,
with fresh random ids for every gathered launch. Each time is a CUDA-event
median of 20 launches and the kernels' own device time per launch under
torch.profiler. Prints the card, the ``ptxas -v`` lines of both builds and
one JSON line of the times; every shape uses the seeded deep-like corpus of
``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

N, D, LANES, M0, SHARDED_ROWS, REPS = 1_000_000, 96, 16, 32, 64, 20


def build(src: str, out: str, csrc: str, nvcc: str) -> tuple[ctypes.CDLL, str]:
    from repro_torch.kernels import _build

    cmd = [nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-I", csrc, "-o", out, src]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(out)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sim_many.argtypes = [vp, vp, vp, i, ll, i, i, vp]
    lib.sim_gather.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
    return lib, p.stdout + p.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("before", help="the earlier batch_similarity.cu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    csrc = str(_build.CSRC)
    libs, ptxas = {}, {}
    for name, src in (("before", os.path.abspath(args.before)),
                      ("after", str(_build.CSRC / "batch_similarity.cu"))):
        libs[name], ptxas[name] = build(
            src, str(_build.BUILD_DIR / f"ab_{name}.so"), csrc, _build._nvcc())
        print(f"=== ptxas {name}\n{ptxas[name]}", flush=True)

    dev = torch.device("cuda")
    sys.path.insert(0, HERE)
    from chip_smoke import deep_like, device_us, time_ms

    x = deep_like(torch, N, D, args.seed + 100, dev)
    qs = deep_like(torch, SHARDED_ROWS, D, args.seed + 101, dev)
    stream = _build.stream()
    l2 = _build.metric_code("l2")

    def many(lib, q):
        out = torch.empty((q.shape[0], N), device=dev)
        _build.check(lib.sim_many(q.data_ptr(), x.data_ptr(), out.data_ptr(),
                                  q.shape[0], N, D, l2, stream), "sim_many")
        return out

    def gather(lib, q, ids):
        out = torch.empty(ids.shape, device=dev)
        _build.check(lib.sim_gather(q.data_ptr(), x.data_ptr(), ids.data_ptr(),
                                    out.data_ptr(), q.shape[0], ids.shape[1], D,
                                    l2, stream), "sim_gather")
        return out

    g = torch.Generator(device=dev).manual_seed(args.seed + 2)

    def fresh_ids(rows, count):
        return iter([torch.randint(-1, N, (rows, M0), device=dev,
                                   dtype=torch.int32, generator=g)
                     for _ in range(count)])

    q16 = qs[:LANES].contiguous()
    cases = {
        "sim_many_16x1M": lambda lib, it: many(lib, q16),
        "sim_gather_16x32": lambda lib, it: gather(lib, q16, next(it)),
        "sim_gather_64x32": lambda lib, it: gather(lib, qs, next(it)),
    }
    rows_of = {"sim_many_16x1M": LANES, "sim_gather_16x32": LANES,
               "sim_gather_64x32": SHARDED_ROWS}
    for case, fn in cases.items():     # the same bits from both builds
        g.manual_seed(args.seed + 2)
        a = fn(libs["before"], fresh_ids(rows_of[case], 1))
        g.manual_seed(args.seed + 2)
        b = fn(libs["after"], fresh_ids(rows_of[case], 1))
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{case}: the two builds give other bits")

    result = {"nvidia_smi": smi, "torch": torch.__version__}
    for case, fn in cases.items():
        kernel = case.rsplit("_", 1)[0] + "_kernel"
        runs = []
        for name in ("before", "after", "after", "before"):
            it = fresh_ids(rows_of[case], 4 * REPS + 2)
            runs.append(dict(
                build=name, ms=time_ms(torch, lambda: fn(libs[name], it), REPS),
                device_us=device_us(torch, lambda: fn(libs[name], it), kernel,
                                    REPS)[0]))
        result[case] = runs
        print(f"{case}: " + json.dumps(runs), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
