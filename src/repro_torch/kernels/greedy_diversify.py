"""CUDA kernel: batched greedy diverse selection (``csrc/greedy_diversify.cu``).

Replaces the Pallas kernels ``greedy_diversify_pallas``
(``src/repro/kernels/greedy_diversify.py:46``) and
``greedy_diversify_batch_pallas`` (``:64``): k greedy steps (masked argmax,
lowest index on ties; ban the pick's adjacency row and the pick) over
scores f32 (B, K), -inf marking an invalid candidate, and adjacency (B, K, K).

Bound on the card: the scores and the k picked rows are few bytes; the
floor is the chain of k dependent steps. Up to K = 1024 one warp holds a
lane, its scores in registers and its banned set in one register word a
thread, so a step has no block barrier: the rows are staged whole in
shared memory at launch up to K = 128, and past that each thread's part of
the rows of the next candidates in score order is loaded into registers
ahead of need. Wider lanes take a block each, with one barrier a step
(``greedy_plan``). The plain version is ``kernels.ref.greedy_diversify``.
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
        lib.greedy_plan.argtypes = [i, p]
        lib.greedy_plan.restype = i
        lib._typed = True
    return lib


ROUTES = ("staged", "prefetch", "block", "block_streamed")


def greedy_plan(W: int) -> dict:
    """The route a lane of W candidates runs on: "staged" (one warp, the
    lane's W x W bytes in shared memory), "prefetch" (one warp, the rows of
    the next candidates in score order loaded ahead into registers),
    "block" (one block, the scores in shared memory) or "block_streamed"
    (one block, the scores read from device memory); threads a lane,
    candidates a thread (warp routes) and dynamic shared memory bytes."""
    out = (ctypes.c_longlong * 4)()
    _build.check(_lib().greedy_plan(W, out), "greedy_plan")
    return dict(route=ROUTES[out[0]], threads=out[1], per_thread=out[2],
                smem=out[3])


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
