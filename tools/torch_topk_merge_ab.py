#!/usr/bin/env python3
"""Time the sharded search's tournament merge two ways on one CUDA card, in
turns: an earlier build's butterfly (log2 P two-run ``topk_merge`` launches,
each round's partner lists exchanged by a gather on a host-built index)
against this checkout's one ``topk_tournament`` launch.

Run from the root of a checkout, on a machine with a card, with the earlier
kernel sources unpacked into a directory of their own:

    mkdir -p build/before
    git archive <commit> src/repro_torch/kernels/csrc \\
        | tar -x -C build/before --strip-components=3
    python3 tools/torch_topk_merge_ab.py build/before/csrc

"before" is the given directory's ``topk_merge.cu`` (its C entry
``topk_merge``), compiled with the flags of ``repro_torch.kernels._build``
and driven as the sharded search drove it before the tournament kernel:
per round, the partner exchange the earlier ``LocalMesh.ppermute`` made
twice (a permutation index built on the host and copied to the card, then
a gather) and the two-run wrapper's checks, reshapes and output
allocations. "after" is this checkout's
``sharded_search.search._tournament_merge``, one ``topk_tournament``
launch. Shapes: P = 4 shards, B = 16 lanes, L in {32, 64, 4096}, on
``chip_smoke.tournament_runs`` (shards share ids, ties on both keys,
+-0.0, padding). Both must equal the plain butterfly
(``kernels.ref.topk_tournament``), ids and score bits.

Each is timed before / after / after / before: a CUDA-event median of 20
tournaments, and under torch.profiler the device time per tournament of
everything it launched (``device_us``: kernels, gathers and host-to-device
copies) and of its merge kernels alone (``kernel_us``), from the sessions'
events that carry a duration. Prints the card and one JSON line of the
times.
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

P, B, LS, REPS = 4, 16, (32, 64, 4096), 20
PRIMARY = {"before": "topk_merge_kernel", "after": "topk_tournament_kernel"}


def build(csrc: str, out: str):
    from repro_torch.kernels import _build

    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas",
           "-v", "-shared", "-Xcompiler", "-fPIC", "-I", csrc, "-o", out,
           os.path.join(csrc, "topk_merge.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc topk_merge.cu in {csrc} failed:\n"
                           f"{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(out)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_merge.argtypes = [vp, vp, vp, vp, vp, vp, i, i, vp]
    lib.topk_merge.restype = i
    return lib, p.stdout + p.stderr


def device_split(torch, fn, primary: str, per_call: int, reps: int = REPS):
    """Device µs per call of ``fn()`` under torch.profiler, of every event
    it launched and of the kernels named ``primary`` (``per_call`` of them
    a call), over the calls whose ``primary`` launches the profiler kept
    with a duration; a session that kept under half is run again, up to
    three in all (None if none did). Also the kept launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.device_time_total > 0]
        mine = [e for e in events if primary in e.name]
        if 2 * len(mine) >= reps * per_call:
            calls = len(mine) / per_call
            return (sum(e.device_time_total for e in events) / calls,
                    sum(e.device_time_total for e in mine) / calls, len(mine))
    return None, None, len(mine)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("before", help="directory of the earlier csrc sources")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as plain
    from repro_torch.sharded_search import search as ssearch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib, log = build(os.path.abspath(args.before),
                     str(_build.BUILD_DIR / "ab_before_topk_merge.so"))
    print(f"=== ptxas before topk_merge\n{log}", flush=True)
    print(f"=== ptxas after topk_merge\n{_build.ptxas_log('topk_merge')}",
          flush=True)

    dev = torch.device("cuda")
    sys.path.insert(0, HERE)
    from chip_smoke import time_ms, tournament_runs

    rounds = P.bit_length() - 1

    def merge_before(ia, sa, ib, sb):
        # the two-run wrapper's rung of kernels.ops.topk_merge, as it was
        lead, L = ia.shape[:-1], ia.shape[-1]
        ins = [t.reshape(-1, L).contiguous() for t in (
            ia.to(torch.int32).contiguous(), sa.to(torch.float32).contiguous(),
            ib.to(torch.int32).contiguous(), sb.to(torch.float32).contiguous())]
        for name, t, dtype in zip(("ids_a", "scores_a", "ids_b", "scores_b"),
                                  ins, (torch.int32, torch.float32) * 2):
            _build.check_cuda(name, t, dtype, 2)
        io, so = torch.empty_like(ins[0]), torch.empty_like(ins[1])
        _build.check(lib.topk_merge(*(t.data_ptr() for t in ins),
                                    io.data_ptr(), so.data_ptr(),
                                    ins[0].shape[0], L, _build.stream()),
                     "topk_merge (before)")
        return io.reshape(*lead, L), so.reshape(*lead, L)

    def partner(x, r):
        # the earlier ppermute: an index built on the host, then a gather
        return x[torch.tensor([i ^ (1 << r) for i in range(P)],
                              device=x.device)]

    def before(ids, sc):
        for r in range(rounds):
            ids, sc = merge_before(ids, sc, partner(ids, r), partner(sc, r))
        return ids[0], sc[0]

    sides = {"before": (before, rounds),
             "after": (ssearch._tournament_merge, 1)}
    result = {"nvidia_smi": smi, "torch": torch.__version__,
              "shards": P, "lanes": B}
    for L in LS:
        ids, sc = tournament_runs(torch, P, B, L, args.seed + L, dev)
        ri, rs = plain.topk_tournament(ids, sc)
        for side, (fn, _) in sides.items():
            gi, gs = fn(ids, sc)
            if not (torch.equal(gi, ri) and torch.equal(
                    gs.view(torch.int32), rs.view(torch.int32))):
                raise AssertionError(f"{side} differs from the plain "
                                     f"butterfly at L = {L}")
        runs = []
        for side in ("before", "after", "after", "before"):
            fn, per_call = sides[side]
            dev_us, kern_us, kept = device_split(
                torch, lambda: fn(ids, sc), PRIMARY[side], per_call)
            runs.append(dict(build=side,
                             ms=time_ms(torch, lambda: fn(ids, sc), REPS),
                             device_us=dev_us, kernel_us=kern_us,
                             kept=kept))
        result[f"L{L}"] = runs
        print(f"P={P} B={B} L={L}: " + json.dumps(runs), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
