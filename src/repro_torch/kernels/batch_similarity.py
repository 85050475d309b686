"""CUDA kernel: batched similarity scoring (``csrc/batch_similarity.cu``).

Replaces the Pallas kernel ``batch_similarity_many_pallas``
(``src/repro/kernels/batch_similarity.py:51``) in two shapes the engine
needs: the growth rebuild's corpus shape (every lane's query against the
whole corpus, ``sim_many_cuda``) and the burst's gather shape (each lane's
query against the M0 neighbour rows of its expanded node,
``sim_gather_cuda``, with the row gather fused into the kernel).

What bounds each on the card, and what the design does about it:

- The corpus shape reads N*d*4 bytes for B*N*d*2 flops (~1.4 flop per
  byte at B=16, d=96): bound by bytes. A persistent grid stages tiles of
  consecutive rows into shared memory with ``cp.async`` in a two-stage
  ring, so each row is read from device memory once, coalesced, while the
  previous tile is scored; each thread scores one row against every query
  of the launch (up to 16, broadcast from shared memory) in registers.
- The gather shape is a few hundred outputs: bound by its launch. A grid of
  (4-row chunk, lane) blocks spreads it over the SMs; each block copies its
  rows and query into shared memory before any arithmetic and computes
  each norm once.

Every output is reduced over d in one fixed sequential order (``csrc/sim.cuh``),
so scores do not depend on the batch or the entry point and equal the
plain versions bit for bit. That order is why neither kernel uses the
tensor cores, which sum over d in blocks.

The plain versions are ``kernels.ref.batch_similarity`` (per-lane
``query_sim``) and ``kernels.ref.batch_similarity_gather``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda, metric_code, stream


def _lib():
    lib = _build.load("batch_similarity")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sim_many.argtypes = [p, p, p, i, ll, i, i, p]
        lib.sim_many.restype = i
        lib.sim_gather.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.sim_gather.restype = i
        lib._typed = True
    return lib


def sim_many_cuda(qs: torch.Tensor, x: torch.Tensor,
                  metric: str) -> torch.Tensor:
    """scores[b, n] = sim(qs[b], x[n]) -> f32[B, N] on the card."""
    check_cuda("qs", qs, torch.float32, 2)
    check_cuda("x", x, torch.float32, 2)
    B, d = qs.shape
    N = x.shape[0]
    if x.shape[1] != d or x.device != qs.device:
        raise ValueError("qs and x must share d and device")
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    _build.check(_lib().sim_many(qs.data_ptr(), x.data_ptr(), out.data_ptr(),
                                 B, N, d, metric_code(metric), stream()),
                 "sim_many")
    sim_many_cuda.launches += 1
    return out


sim_many_cuda.launches = 0


def sim_gather_cuda(qs: torch.Tensor, x: torch.Tensor, ids: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """scores[b, m] = sim(qs[b], x[max(ids[b, m], 0)]) -> f32[B, M]."""
    check_cuda("qs", qs, torch.float32, 2)
    check_cuda("x", x, torch.float32, 2)
    check_cuda("ids", ids, torch.int32, 2)
    B, d = qs.shape
    M = ids.shape[1]
    if x.shape[1] != d or ids.shape[0] != B:
        raise ValueError("qs, x and ids disagree in shape")
    out = torch.empty((B, M), dtype=torch.float32, device=x.device)
    _build.check(_lib().sim_gather(qs.data_ptr(), x.data_ptr(), ids.data_ptr(),
                                   out.data_ptr(), B, M, d,
                                   metric_code(metric), stream()),
                 "sim_gather")
    sim_gather_cuda.launches += 1
    return out


sim_gather_cuda.launches = 0
