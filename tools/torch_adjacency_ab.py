#!/usr/bin/env python3
"""Time two builds of the adjacency and fused-round kernels on one CUDA card,
in turns.

Run from the root of a checkout, on a machine with a card, with the earlier
kernel sources unpacked into a directory of their own:

    mkdir -p build/before
    git archive <commit> src/repro_torch/kernels/csrc \\
        | tar -x -C build/before --strip-components=3
    python3 tools/torch_adjacency_ab.py build/before/csrc

"before" is the interface of the slice-1 kernels (up to commit eef8b52):
``adjacency_batch`` writes the raw thresholded Gram as uint8 and the wrapper
strips the diagonal and the padding in torch; ``fused_round`` takes a
scratch buffer and returns local picks and their scores, from which the
wrapper derives the global ids, the count and the certificate in torch.
The tool reproduces those wrappers, so each side is timed as the path
calls it. "after" is this checkout's ``csrc``. Both are compiled with the
flags of ``repro_torch.kernels._build``, each against its own headers, and
held to equal outputs (the certificate's total within 1e-5) at every
shape. Then each is timed before / after / after / before at each
lanes x width of ``--shapes`` (l2, seeded deep-like corpus of 1M x 96, the
tie-free prefixes of ``chip_smoke.py``): a CUDA-event median of 20 calls and
the device time per call under torch.profiler. Prints the card, the
``ptxas -v`` lines of both builds and one JSON line of the times.

``--routes 16x1024,16x4096`` also times this checkout's fused round as it
is ("staged": at those widths a cluster of 8 blocks holds a lane's rows in
shared memory) against a build of the same source whose plan never stages
a cluster ("streamed": the cluster reads each candidate's row from device
memory at every step), in turns staged / streamed / streamed / staged,
held to equal outputs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

N, D, K, REPS = 1_000_000, 96, 10, 20
SOURCES = ("pairwise_adjacency", "fused_round")
# fused_round.cu's plan tries one block, then a staged cluster of 8; the
# streamed variant tries one block only, so a lane that needs a cluster
# streams its rows
PLAN_LOOP = "for (int C : {1, kMaxCluster})"


def build(csrc: str, name: str, out: str, nvcc: str):
    from repro_torch.kernels import _build

    cmd = [nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-I", csrc, "-o", out,
           os.path.join(csrc, f"{name}.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc {name}.cu in {csrc} failed:\n"
                           f"{p.stdout}{p.stderr}")
    return ctypes.CDLL(out), p.stdout + p.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("before", help="directory of the earlier csrc sources")
    ap.add_argument("--shapes", default="16x64,16x1024",
                    help="comma-separated lanes x widths to time at")
    ap.add_argument("--routes", default="",
                    help="lanes x widths at which to time the fused "
                         "round's staged cluster against the streamed one")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import similarity as sim
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    libs: dict = {}
    builds = [(side, csrc, name)
              for side, csrc in (("before", os.path.abspath(args.before)),
                                 ("after", str(_build.CSRC)))
              for name in SOURCES]
    if args.routes:
        streamed = _build.BUILD_DIR / "ab_streamed_csrc"
        shutil.rmtree(streamed, ignore_errors=True)
        shutil.copytree(_build.CSRC, streamed)
        src = (streamed / "fused_round.cu").read_text()
        if src.count(PLAN_LOOP) != 1:
            raise RuntimeError(f"fused_round.cu has no {PLAN_LOOP!r}")
        (streamed / "fused_round.cu").write_text(
            src.replace(PLAN_LOOP, "for (int C : {1})"))
        builds.append(("streamed", str(streamed), "fused_round"))
    for side, csrc, name in builds:
        lib, log = build(csrc, name,
                         str(_build.BUILD_DIR / f"ab_{side}_{name}.so"),
                         _build._nvcc())
        libs[side, name] = lib
        print(f"=== ptxas {side} {name}\n{log}", flush=True)
    vp, i = ctypes.c_void_p, ctypes.c_int
    for side in ("before", "after"):
        libs[side, "pairwise_adjacency"].adjacency_batch.argtypes = (
            [vp] * 4 + [i] * 4 + [vp])
    libs["before", "fused_round"].fused_round.argtypes = (
        [vp] * 8 + [i] * 5 + [vp])
    for side in ("after", "streamed"):
        if (side, "fused_round") in libs:
            libs[side, "fused_round"].fused_round.argtypes = (
                [vp] * 9 + [i] * 5 + [vp])
            libs[side, "fused_round"].fused_round_plan.argtypes = [i, i, vp]

    dev = torch.device("cuda")
    sys.path.insert(0, HERE)
    from chip_smoke import deep_like, device_us, tie_free_prefixes, time_ms

    x = deep_like(torch, N, D, args.seed + 100, dev)
    stream = _build.stream()
    l2 = _build.metric_code("l2")

    def adjacency(side, ids, eps):
        G, W = ids.shape
        raw = torch.empty((G, W, W), dtype=torch.uint8 if side == "before"
                          else torch.bool, device=dev)
        _build.check(libs[side, "pairwise_adjacency"].adjacency_batch(
            x.data_ptr(), ids.data_ptr(), eps.data_ptr(), raw.data_ptr(), G,
            W, D, l2, stream), "adjacency_batch")
        return ref.strip_adjacency(raw, ids >= 0) if side == "before" else raw

    def fused(side, ids, scores, Ks, eps):
        B, W = ids.shape
        selsc = torch.empty((B, K), dtype=torch.float32, device=dev)
        lib = libs[side, "fused_round"]
        if side == "before":
            sel = torch.empty((B, K), dtype=torch.int32, device=dev)
            scratch = torch.empty((B, W, (W + 31) // 32), dtype=torch.int32,
                                  device=dev)
            _build.check(lib.fused_round(
                x.data_ptr(), ids.data_ptr(), scores.data_ptr(),
                Ks.data_ptr(), eps.data_ptr(), scratch.data_ptr(),
                sel.data_ptr(), selsc.data_ptr(), B, W, D, K, l2, stream),
                "fused_round")
            ids_m, scores_m = ref.mask_prefix(ids, scores, Ks)
            sel_ids, _ = ref.extract_round(sel, ids_m, scores_m)
            count = torch.sum(sel >= 0, dim=1).to(torch.int32)
            valid = ids_m >= 0   # the slice-1 certificate: torch.sum's order
            s_K = torch.min(torch.where(valid, scores_m, float("inf")),
                            dim=1).values
            s_K = torch.where(valid.any(dim=1), s_K, float("-inf"))
            return sel_ids, selsc, count, torch.stack(
                [torch.sum(selsc, dim=1), s_K], dim=1)
        sel_ids = torch.empty((B, K), dtype=torch.int32, device=dev)
        count = torch.empty((B,), dtype=torch.int32, device=dev)
        cert = torch.empty((B, 2), dtype=torch.float32, device=dev)
        _build.check(lib.fused_round(
            x.data_ptr(), ids.data_ptr(), scores.data_ptr(), Ks.data_ptr(),
            eps.data_ptr(), sel_ids.data_ptr(), selsc.data_ptr(),
            count.data_ptr(), cert.data_ptr(), B, W, D, K, l2, stream),
            "fused_round")
        return sel_ids, selsc, count, cert

    primary = {("before", "pairwise_adjacency"): "adjacency_kernel",
               ("after", "pairwise_adjacency"): "adjacency_kernel",
               ("before", "fused_round"): "fused_adj_kernel",
               ("after", "fused_round"): "fused_round_kernel",
               ("streamed", "fused_round"): "fused_round_kernel"}
    result = {"nvidia_smi": smi, "torch": torch.__version__}
    for shape in args.shapes.split(","):
        lanes, W = (int(v) for v in shape.split("x"))
        ids, scores, Ks, eps = tie_free_prefixes(torch, sim, x, lanes, W,
                                                 "l2", args.seed + W, dev)
        plain = ops.pairwise_adjacency_batch(x, ids, eps, "l2", impl="ref")
        for side in ("before", "after"):   # equal outputs from both builds
            if not torch.equal(adjacency(side, ids, eps), plain):
                raise AssertionError(f"adjacency {side} differs at W={W}")
        fb, fa = (fused(side, ids, scores, Ks, eps)
                  for side in ("before", "after"))
        if not all(torch.equal(a, b) for a, b in zip(fb[:3], fa[:3])):
            raise AssertionError(f"fused round: the builds differ at W={W}")
        torch.testing.assert_close(fa[3], fb[3], rtol=1e-5, atol=1e-5)
        calls = {"pairwise_adjacency": lambda side: adjacency(side, ids, eps),
                 "fused_round": lambda side: fused(side, ids, scores, Ks,
                                                   eps)}
        for name, fn in calls.items():
            runs = []
            for side in ("before", "after", "after", "before"):
                runs.append(dict(
                    build=side,
                    ms=time_ms(torch, lambda: fn(side), REPS),
                    device_us=device_us(torch, lambda: fn(side),
                                        primary[side, name], REPS)[0]))
            result[f"{name}_{lanes}x{W}"] = runs
            print(f"{name} {lanes} x {W}: " + json.dumps(runs), flush=True)
    for shape in filter(None, args.routes.split(",")):
        lanes, W = (int(v) for v in shape.split("x"))
        plans = {}
        for side in ("after", "streamed"):
            out = (ctypes.c_longlong * 5)()
            _build.check(libs[side, "fused_round"].fused_round_plan(W, D, out),
                         "fused_round_plan")
            plans[side] = dict(cluster=out[0], staged=out[1],
                               threads=out[2], per_block=out[3], smem=out[4])
        if not (plans["after"]["staged"] and plans["after"]["cluster"] > 1
                and not plans["streamed"]["staged"]):
            raise AssertionError(f"{lanes} x {W} is no staged-cluster width: "
                                 + json.dumps(plans))
        ids, scores, Ks, eps = tie_free_prefixes(torch, sim, x, lanes, W,
                                                 "l2", args.seed + W, dev)
        fs, fm = (fused(side, ids, scores, Ks, eps)
                  for side in ("after", "streamed"))
        if not all(torch.equal(a, b) for a, b in zip(fs, fm)):
            raise AssertionError(f"fused round routes differ at W={W}")
        runs = []
        for side in ("after", "streamed", "streamed", "after"):
            fn = lambda: fused(side, ids, scores, Ks, eps)
            runs.append(dict(
                route="staged" if side == "after" else "streamed",
                ms=time_ms(torch, fn, REPS),
                device_us=device_us(torch, fn, primary[side, "fused_round"],
                                    REPS)[0]))
        result[f"fused_round_routes_{lanes}x{W}"] = dict(plans=plans,
                                                         runs=runs)
        print(f"fused_round routes {lanes} x {W}: " + json.dumps(
            dict(plans=plans, runs=runs)), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
