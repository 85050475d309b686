#!/usr/bin/env python3
"""Time two builds of the PQ lookup-sum and greedy kernels on one CUDA card,
in turns.

Run from the root of a checkout, on a machine with a card, with the earlier
kernel sources unpacked into a directory of their own:

    mkdir -p build/before
    git archive <commit> src/repro_torch/kernels/csrc \\
        | tar -x -C build/before --strip-components=3
    python3 tools/torch_lut_greedy_ab.py build/before/csrc

Both builds keep the C interfaces ``pq_lut_sum`` and ``greedy_batch``.
"before" is the given directory's ``pq_lut_sum.cu`` and
``greedy_diversify.cu``, "after" this checkout's; each is compiled with the
flags of ``repro_torch.kernels._build`` against its own headers. Shapes (the
seeded deep-like corpus of ``chip_smoke.py``, 1M x 96):

- ``pq_lut_sum`` over the corpus's PQ codes (16 subspaces, 256 centroids,
  10 k-means iterations, as phase 5 of ``chip_smoke.py`` builds them): the
  l2 tables of 16 queries (16 x 1M), and the centroid norms' table alone
  (1 x 1M, the cos path's second call).
- ``greedy_diversify`` at k = 10 over ``chip_smoke.tie_free_prefixes`` at 16
  lanes of W = 1024 and of W = 64, with the plain adjacency at each lane's
  eps and -inf scores past the valid candidates; then the same lanes with
  each lane's candidates in a random order (``_unsorted``): the same picks
  up to that order, and the same work for a kernel that does not depend
  on the order.

Each build's output must equal the plain version's at every shape (the sums
bit for bit). Then each is timed before / after / after / before: a
CUDA-event median of 20 calls and the kernels' device time per call under
torch.profiler. Prints the card, the ``ptxas -v`` lines of both builds and
one JSON line of the times, with the SM clock nvidia-smi reads while the
LUT sum keeps the card busy.
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

N, D, K, REPS, PQ_ITERS = 1_000_000, 96, 10, 20, 10
SOURCES = ("pq_lut_sum", "greedy_diversify")
GREEDY_SHAPES = ((16, 1024), (16, 64))
PRIMARY = {"pq_lut_sum": "pq_lut_sum_kernel", "greedy_diversify": "greedy_"}


def build(csrc: str, name: str, out: str, nvcc: str):
    from repro_torch.kernels import _build

    cmd = [nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-I", csrc, "-o", out,
           os.path.join(csrc, f"{name}.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc {name}.cu in {csrc} failed:\n"
                           f"{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(out)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "pq_lut_sum":
        lib.pq_lut_sum.argtypes = [vp, vp, vp, i, ll, i, i, vp]
    else:
        lib.greedy_batch.argtypes = [vp, vp, vp, i, i, i, vp]
    return lib, p.stdout + p.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("before", help="directory of the earlier csrc sources")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import quant
    from repro_torch.core import similarity as sim
    from repro_torch.kernels import _build, ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    libs: dict = {}
    for side, csrc in (("before", os.path.abspath(args.before)),
                       ("after", str(_build.CSRC))):
        for name in SOURCES:
            libs[side, name], log = build(
                csrc, name, str(_build.BUILD_DIR / f"ab_{side}_{name}.so"),
                _build._nvcc())
            print(f"=== ptxas {side} {name}\n{log}", flush=True)

    dev = torch.device("cuda")
    sys.path.insert(0, HERE)
    from chip_smoke import (deep_like, device_us, sm_clock_mhz,
                            tie_free_prefixes, time_ms)

    stream = _build.stream()

    def lut_sum(side, T, codes):
        B, M, C = T.shape
        out = torch.empty((B, codes.shape[0]), dtype=torch.float32,
                          device=dev)
        _build.check(libs[side, "pq_lut_sum"].pq_lut_sum(
            T.data_ptr(), codes.data_ptr(), out.data_ptr(), B,
            codes.shape[0], M, C, stream), "pq_lut_sum")
        return out

    def greedy(side, scores, adj):
        B, W = scores.shape
        sel = torch.empty((B, K), dtype=torch.int32, device=dev)
        _build.check(libs[side, "greedy_diversify"].greedy_batch(
            scores.data_ptr(), adj.data_ptr(), sel.data_ptr(), B, W, K,
            stream), "greedy_batch")
        return sel

    x = deep_like(torch, N, D, args.seed + 100, dev)
    qs = deep_like(torch, 16, D, args.seed + 101, dev)
    pq = quant.quantize_corpus(x, "pq", pq_iters=PQ_ITERS, seed=args.seed)
    T, _, _ = quant.pq_luts_many(qs, pq.codebooks, "l2")
    _, S, _ = quant.pq_luts_many(qs, pq.codebooks, "cos")
    calls = {}
    for label, table in (("16x1M", T.contiguous()),
                         ("1x1M", S[None].contiguous())):
        want = quant.pq_lut_sum(table, pq.codes)
        for side in ("before", "after"):
            got = lut_sum(side, table, pq.codes)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"pq_lut_sum {side} differs at {label}")
        calls[f"pq_lut_sum_{label}"] = (
            "pq_lut_sum",
            lambda side, table=table: lut_sum(side, table, pq.codes))
    for lanes, W in GREEDY_SHAPES:
        ids, scores, _, eps = tie_free_prefixes(torch, sim, x, lanes, W, "l2",
                                                args.seed + W, dev)
        adj = ops.pairwise_adjacency_batch(x, ids, eps, "l2", impl="ref")
        s = torch.where(ids >= 0, scores, float("-inf")).contiguous()
        a8 = adj.view(torch.uint8).contiguous()
        want = ops.greedy_diversify_batch(s, adj, K, impl="ref")[0]
        for side in ("before", "after"):
            if not torch.equal(greedy(side, s, a8), want):
                raise AssertionError(f"greedy {side} differs at "
                                     f"{lanes} x {W}")
        calls[f"greedy_diversify_{lanes}x{W}"] = (
            "greedy_diversify",
            lambda side, s=s, a8=a8: greedy(side, s, a8))
        g = torch.Generator(device=dev).manual_seed(args.seed + W)
        perm = torch.stack([torch.randperm(W, generator=g, device=dev)
                            for _ in range(lanes)])
        lane = torch.arange(lanes, device=dev)[:, None, None]
        sp = torch.gather(s, 1, perm).contiguous()
        ap = a8[lane, perm[:, :, None], perm[:, None, :]].contiguous()
        want = ops.greedy_diversify_batch(sp, ap != 0, K, impl="ref")[0]
        for side in ("before", "after"):
            if not torch.equal(greedy(side, sp, ap), want):
                raise AssertionError(f"greedy {side} differs at "
                                     f"{lanes} x {W}, unsorted")
        calls[f"greedy_diversify_{lanes}x{W}_unsorted"] = (
            "greedy_diversify",
            lambda side, sp=sp, ap=ap: greedy(side, sp, ap))
    del x
    result = {"nvidia_smi": smi, "torch": torch.__version__}
    for label, (name, fn) in calls.items():
        runs = []
        for side in ("before", "after", "after", "before"):
            runs.append(dict(
                build=side, ms=time_ms(torch, lambda: fn(side), REPS),
                device_us=device_us(torch, lambda: fn(side), PRIMARY[name],
                                    REPS)[0]))
        result[label] = runs
        print(f"{label}: " + json.dumps(runs), flush=True)
    result["sm_clock_mhz_under_load"] = sm_clock_mhz(
        torch, lambda: calls["pq_lut_sum_16x1M"][1]("after"))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
