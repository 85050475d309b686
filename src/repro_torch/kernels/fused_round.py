"""CUDA kernel: one fused progressive round per lane (``csrc/fused_round.cu``).

Replaces the Pallas kernel ``fused_round_batch_pallas``
(``src/repro/kernels/fused_round.py:99``): mask each lane's raw queue prefix
to ``Ks[b]``, gather its rows and run k greedy steps over G^eps at
``> eps[b]``. One launch writes everything the round returns:
``sel_ids`` int32 (B, k) the picks' global ids, -1 padded, ``selsc`` f32
(B, k) picked scores, 0 where no pick, ``count`` int32 (B,) and ``cert``
f32 (B, 2) = (the picked scores' sum in pick order, the smallest valid
score or -inf).

The TPU kernel thresholds the whole W x W Gram and runs greedy on it.
Greedy only reads the rows it picks, so the kernel scores each pick against
the candidates still unbanned: k*W sims, not W*W. A lane's candidates sit
in shared memory, in one block or split over a thread-block cluster of up
to 8; past what 8 blocks hold, they stream from device memory
(``fused_round_plan``). Bound on the card: the prefix's bytes, but the
floor is the chain of k dependent steps. The plain version is
``kernels.ref.fused_round``.
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
        lib.fused_round.argtypes = [p] * 9 + [i] * 5 + [p]
        lib.fused_round.restype = i
        lib.fused_round_plan.argtypes = [i, i, p]
        lib.fused_round_plan.restype = i
        lib._typed = True
    return lib


def fused_round_plan(W: int, d: int) -> dict:
    """The layout the kernel runs a round of width W at dimension d with:
    cluster size, staged (rows in shared memory) or streamed, threads and
    candidates a block, and shared memory bytes a block."""
    out = (ctypes.c_longlong * 5)()
    _build.check(_lib().fused_round_plan(W, d, out), "fused_round_plan")
    return dict(cluster=out[0], route="staged" if out[1] else "streamed",
                threads=out[2], per_block=out[3], smem=out[4])


def fused_round_cuda(vectors: torch.Tensor, ids: torch.Tensor,
                     scores: torch.Tensor, Ks: torch.Tensor, eps: torch.Tensor,
                     k: int, metric: str):
    """(sel_ids int32[B, k], selsc f32[B, k], count int32[B],
    cert f32[B, 2]) for raw prefixes ids/scores (B, W)."""
    check_cuda("vectors", vectors, torch.float32, 2)
    check_cuda("ids", ids, torch.int32, 2)
    check_cuda("scores", scores, torch.float32, 2)
    check_cuda("Ks", Ks, torch.int32, 1)
    check_cuda("eps", eps, torch.float32, 1)
    B, W = ids.shape
    if scores.shape != (B, W) or Ks.shape[0] != B or eps.shape[0] != B:
        raise ValueError("ids, scores, Ks and eps disagree in shape")
    dev = vectors.device
    sel_ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    selsc = torch.empty((B, k), dtype=torch.float32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    cert = torch.empty((B, 2), dtype=torch.float32, device=dev)
    _build.check(_lib().fused_round(
        vectors.data_ptr(), ids.data_ptr(), scores.data_ptr(), Ks.data_ptr(),
        eps.data_ptr(), sel_ids.data_ptr(), selsc.data_ptr(),
        count.data_ptr(), cert.data_ptr(), B, W, vectors.shape[1], k,
        metric_code(metric), stream()), "fused_round")
    fused_round_cuda.launches += 1
    return sel_ids, selsc, count, cert


fused_round_cuda.launches = 0
