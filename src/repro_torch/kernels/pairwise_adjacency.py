"""CUDA kernel: batched diversity-graph adjacency (``csrc/pairwise_adjacency.cu``).

Replaces the Pallas kernel ``pairwise_adjacency_pallas``
(``src/repro/kernels/pairwise_adjacency.py:46``). The engine used to vmap
that kernel per lane (``_batched_adjacency``); here one launch builds every
lane's finished ``(W, W)`` adjacency against its own eps, with the row
gather, the diagonal and the padding mask inside the kernel:

    adj[g, i, j] = i != j and ids[g, i] >= 0 and ids[g, j] >= 0
                   and sim(x[ids[g, i]], x[ids[g, j]]) > eps[g]

Bound on the card: G*W*(W-1)/2 sims of 2d flops each (one triangle: sim is
bitwise symmetric) against G*W*d*4 bytes in and G*W^2 bytes out, so it is
bound by operations (float32 on the CUDA cores: each sim is one sequential
fma chain, which rules out the tensor cores). Each block computes one
64 x 64 tile of the upper triangle, 8 x 8 outputs a thread in registers,
and writes it and its mirror. The plain version is
``kernels.ref.pairwise_adjacency`` on the gathered rows.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda, metric_code, stream


def _lib():
    lib = _build.load("pairwise_adjacency")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.adjacency_batch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.adjacency_batch.restype = i
        lib._typed = True
    return lib


def adjacency_cuda(x: torch.Tensor, ids: torch.Tensor, eps: torch.Tensor,
                   metric: str) -> torch.Tensor:
    """Each lane's G^eps adjacency bool[G, W, W] among rows ``x[ids[g]]``."""
    check_cuda("x", x, torch.float32, 2)
    check_cuda("ids", ids, torch.int32, 2)
    check_cuda("eps", eps, torch.float32, 1)
    G, W = ids.shape
    if eps.shape[0] != G:
        raise ValueError("eps needs one threshold per lane")
    out = torch.empty((G, W, W), dtype=torch.bool, device=x.device)
    _build.check(_lib().adjacency_batch(
        x.data_ptr(), ids.data_ptr(), eps.data_ptr(), out.data_ptr(), G, W,
        x.shape[1], metric_code(metric), stream()), "adjacency_batch")
    adjacency_cuda.launches += 1
    return out


adjacency_cuda.launches = 0
