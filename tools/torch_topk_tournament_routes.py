#!/usr/bin/env python3
"""Time the settings of the tournament kernel (``topk_tournament`` in
``csrc/topk_merge.cu``) against their alternatives on one CUDA card: where
a lane's runs are staged in shared memory, how many entries a block ranks,
and how many lanes of a warp share an entry.

Run from the root of a checkout, on a machine with a card:

    python3 tools/torch_topk_tournament_routes.py

Each variant is this checkout's ``topk_merge.cu`` compiled with the flags
of ``repro_torch.kernels._build`` and one setting overridden by a ``-D``
(``TOPK_STAGE_ENTRIES``, ``TOPK_BLOCK_ENTRIES``, ``TOPK_MAX_LANES``; the
source's defaults are the build the port runs), all compiled at once into
``build/torch_ext/routes/``. At each shape, on
``chip_smoke.tournament_runs`` (shards share ids, ties on both keys,
+-0.0, padding), every variant must equal the plain butterfly
(``kernels.ref.topk_tournament``), ids and score bits; then each is timed
in the order of ``VARIANTS`` and again in reverse: the device µs per launch
under torch.profiler. Prints the card and one JSON line of the times.
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
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

VARIANTS = {
    "default": (),
    "stage_all": ("-DTOPK_STAGE_ENTRIES=1",),            # every lane that fits
    "stage_none": ("-DTOPK_STAGE_ENTRIES=1073741824",),  # device memory only
    "block512": ("-DTOPK_BLOCK_ENTRIES=512",),
    "block2048": ("-DTOPK_BLOCK_ENTRIES=2048",),
    "lanes1": ("-DTOPK_MAX_LANES=1",),                   # a thread an entry
}
SHAPES = ([(4, 16, L) for L in (10, 32, 64, 128, 256, 512, 1000, 2048, 4096)]
          + [(8, 16, L) for L in (32, 64, 256, 1000)]
          + [(2, 16, 32), (64, 2, 100)])


def build_variants(out_dir: str) -> dict:
    from repro_torch.kernels import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS.items():
        out = os.path.join(out_dir, f"topk_merge-{name}.so")
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
               *flags, "-shared", "-Xcompiler", "-fPIC", "-I",
               str(_build.CSRC), "-o", out, str(_build.CSRC / "topk_merge.cu")]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc topk_merge.cu ({name}) failed:\n{log}")
        lib = ctypes.CDLL(out)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_tournament.argtypes = [vp, vp, vp, vp, i, i, i, vp]
        lib.topk_tournament.restype = i
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import tournament_runs
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as plain
    from torch_topk_merge_ab import device_split

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    libs = build_variants(str(_build.BUILD_DIR / "routes"))
    dev = torch.device("cuda")

    def launch(name, ids, sc):
        P, B, L = ids.shape
        oi = torch.empty((B, L), dtype=torch.int32, device=dev)
        os_ = torch.empty((B, L), dtype=torch.float32, device=dev)
        _build.check(libs[name].topk_tournament(
            ids.data_ptr(), sc.data_ptr(), oi.data_ptr(), os_.data_ptr(),
            P, B, L, _build.stream()), f"topk_tournament ({name})")
        return oi, os_

    result = {"nvidia_smi": smi, "torch": torch.__version__}
    for P, B, L in SHAPES:
        ids, sc = tournament_runs(torch, P, B, L, args.seed + 11 + L, dev)
        ri, rs = plain.topk_tournament(ids, sc)
        for name in VARIANTS:
            gi, gs = launch(name, ids, sc)
            if not (torch.equal(gi, ri) and torch.equal(
                    gs.view(torch.int32), rs.view(torch.int32))):
                raise AssertionError(f"{name} differs from the plain "
                                     f"butterfly at P={P}, B={B}, L={L}")
        row = {}
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            us, _, _ = device_split(torch, lambda: launch(name, ids, sc),
                                    "topk_tournament_kernel", 1)
            row.setdefault(name, []).append(us)
        result[f"{P}x{B}x{L}"] = row
        print(f"P={P} B={B} L={L}: " + json.dumps(row), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
