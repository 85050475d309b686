"""CUDA kernel: batched greedy diverse selection (``csrc/greedy_diversify.cu``).

Replaces the Pallas kernels ``greedy_diversify_pallas``
(``src/repro/kernels/greedy_diversify.py:46``) and
``greedy_diversify_batch_pallas`` (``:64``): k greedy steps (masked argmax,
lowest index on ties; ban the pick's adjacency row and the pick) over
scores f32 (B, K), -inf marking an invalid candidate, and adjacency (B, K, K).
One block per lane keeps its banned set as a bitmask in shared memory.

Bound on the card: k dependent block-wide reductions per lane, moving
B*k*5K bytes: bound by latency, not by bytes or operations. The device loop
(``csrc/greedy.cuh``) is shared with the fused round. The plain version is
``kernels.ref.greedy_diversify``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda, stream


def _lib():
    lib = _build.load("greedy_diversify")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.greedy_batch.argtypes = [p, p, p, i, i, i, p]
        lib.greedy_batch.restype = i
        lib._typed = True
    return lib


def greedy_cuda(scores: torch.Tensor, adj: torch.Tensor, k: int) -> torch.Tensor:
    """sel int32[B, k] local indices (-1 padded) on the card."""
    check_cuda("scores", scores, torch.float32, 2)
    if adj.dtype == torch.bool:
        adj = adj.view(torch.uint8)
    check_cuda("adj", adj, torch.uint8, 3)
    B, K = scores.shape
    if adj.shape != (B, K, K):
        raise ValueError(f"adj must be {(B, K, K)}, got {tuple(adj.shape)}")
    sel = torch.empty((B, k), dtype=torch.int32, device=scores.device)
    _build.check(_lib().greedy_batch(scores.data_ptr(), adj.data_ptr(),
                                     sel.data_ptr(), B, K, k, stream()),
                 "greedy_batch")
    greedy_cuda.launches += 1
    return sel


greedy_cuda.launches = 0
