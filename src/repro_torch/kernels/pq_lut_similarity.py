"""CUDA kernel: PQ lookup-table sums of the compressed-corpus scorer
(``csrc/pq_lut_sum.cu``).

Replaces the Pallas kernel ``pq_lut_sum_pallas``
(``src/repro/kernels/pq_lut_similarity.py:47``): ``sum_m T[b, m,
codes[n, m]] -> f32[b, n]``, added from ``m = 0`` in turn, so it equals
the plain twin bit for bit. The TPU kernel gathers through one-hot
matmuls; the card gathers from shared memory directly.

Bound on the card: the codes are read once and the sums written once
(n*M + 4*b*M*C + 4*b*n bytes) for b*n*M float additions, so it is bound by
bytes; the b*n*M lookups in shared memory set a floor above that. Each
block holds up to 8 queries' tables in shared memory, interleaved by query
so the queries of one code share one span, and walks the corpus rows.

The plain twin is ``quant.pq_lut_sum``, which the beam loop's block
scorer also uses. Codes must be under C; the wrapper checks that when
C < 256 (a uint8 code is always under 256).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda, stream

#: most shared memory one query's tables may take (M * C * 4 bytes)
MAX_TABLE_BYTES = 200 * 1024


def _lib():
    lib = _build.load("pq_lut_sum")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pq_lut_sum.argtypes = [p, p, p, i, ll, i, i, p]
        lib.pq_lut_sum.restype = i
        lib._typed = True
    return lib


def pq_lut_sum_cuda(T: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """sums f32[b, n] of tables T f32[b, M, C] over codes uint8[n, M] on
    the card."""
    check_cuda("T", T, torch.float32, 3)
    check_cuda("codes", codes, torch.uint8, 2)
    B, M, C = T.shape
    N = codes.shape[0]
    if codes.shape[1] != M or codes.device != T.device:
        raise ValueError("T and codes must share M and device")
    if C > 256 or M * C * 4 > MAX_TABLE_BYTES:
        raise ValueError(f"pq_lut_sum takes C <= 256 and M*C*4 <= "
                         f"{MAX_TABLE_BYTES} bytes, got M={M}, C={C}")
    if C < 256 and N and int(codes.max()) >= C:
        raise ValueError(f"pq_lut_sum: a code is >= C = {C}")
    out = torch.empty((B, N), dtype=torch.float32, device=T.device)
    _build.check(_lib().pq_lut_sum(T.data_ptr(), codes.data_ptr(),
                                   out.data_ptr(), B, N, M, C, stream()),
                 "pq_lut_sum")
    pq_lut_sum_cuda.launches += 1
    return out


pq_lut_sum_cuda.launches = 0
