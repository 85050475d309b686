"""CUDA kernel: one fused progressive round per lane (``csrc/fused_round.cu``).

Replaces the Pallas kernel ``fused_round_batch_pallas``
(``src/repro/kernels/fused_round.py:99``): mask each lane's raw queue prefix
to ``Ks[b]``, gather its rows, threshold the W x W Gram at ``> eps[b]`` and
run k greedy steps. Outputs ``sel`` int32 (B, k) local indices, -1 padded,
and ``selsc`` f32 (B, k) picked scores, 0 where no pick.

The TPU kernel keeps the (W, W) int8 adjacency in VMEM; at W = 1024 that is
1 MB, far over an H100 SM's 227 KB of shared memory. So one call runs two
launches: the adjacency, tile by tile (the same device code as the
adjacency kernel, so the same bits), bit-packed into a W*W/8-byte scratch
buffer per lane that this wrapper allocates; then the greedy loop (the same
device code as the greedy kernel) with one block per lane. Tiles past a
lane's ``Ks[b]`` are skipped. Bound on the card: the Gram's operations.
The plain version is ``kernels.ref.fused_round``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda, metric_code, stream


def _lib():
    lib = _build.load("fused_round")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_round.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.fused_round.restype = i
        lib._typed = True
    return lib


def fused_round_cuda(vectors: torch.Tensor, ids: torch.Tensor,
                     scores: torch.Tensor, Ks: torch.Tensor, eps: torch.Tensor,
                     k: int, metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(sel int32[B, k], selsc f32[B, k]) for raw prefixes ids/scores (B, W)."""
    check_cuda("vectors", vectors, torch.float32, 2)
    check_cuda("ids", ids, torch.int32, 2)
    check_cuda("scores", scores, torch.float32, 2)
    check_cuda("Ks", Ks, torch.int32, 1)
    check_cuda("eps", eps, torch.float32, 1)
    B, W = ids.shape
    if scores.shape != (B, W) or Ks.shape[0] != B or eps.shape[0] != B:
        raise ValueError("ids, scores, Ks and eps disagree in shape")
    dev = vectors.device
    scratch = torch.empty((B, W, (W + 31) // 32), dtype=torch.int32, device=dev)
    sel = torch.empty((B, k), dtype=torch.int32, device=dev)
    selsc = torch.empty((B, k), dtype=torch.float32, device=dev)
    _build.check(_lib().fused_round(
        vectors.data_ptr(), ids.data_ptr(), scores.data_ptr(), Ks.data_ptr(),
        eps.data_ptr(), scratch.data_ptr(), sel.data_ptr(), selsc.data_ptr(),
        B, W, vectors.shape[1], k, metric_code(metric), stream()),
        "fused_round")
    fused_round_cuda.launches += 1
    return sel, selsc


fused_round_cuda.launches = 0
