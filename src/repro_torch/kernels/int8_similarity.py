"""CUDA kernel: exact int8 dots of the compressed-corpus scorer
(``csrc/int8_dot.cu``).

Replaces the Pallas kernel ``int8_dot_pallas``
(``src/repro/kernels/int8_similarity.py:34``): ``q_codes[b, d] .
x_codes[n, d]^T -> int32[b, n]``, int8 operands with int32 accumulation, so
exact. The float postprocess stays outside the kernel, in
``quant.int8_score_from_dots``, shared with the plain path.

Bound on the card: the codes are read once and the dots written once
(n*d + 4*b*n bytes) for 2*b*n*d int8 operations, so it is bound by bytes.
Each block stages a tile of corpus rows in shared memory; each thread
accumulates one row against 16 queries with ``__dp4a``.

The plain twin is ``kernels.ref.int8_dot``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda, stream

#: widest rows the kernel takes (its tile and query chunk fit 48 KB)
MAX_D = 768


def _lib():
    lib = _build.load("int8_dot")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.int8_dot.argtypes = [p, p, p, i, ll, i, p]
        lib.int8_dot.restype = i
        lib._typed = True
    return lib


def int8_dot_cuda(q_codes: torch.Tensor, x_codes: torch.Tensor) -> torch.Tensor:
    """Exact dots int32[b, n] of int8 q_codes[b, d] and x_codes[n, d] on
    the card."""
    check_cuda("q_codes", q_codes, torch.int8, 2)
    check_cuda("x_codes", x_codes, torch.int8, 2)
    B, d = q_codes.shape
    N = x_codes.shape[0]
    if x_codes.shape[1] != d or x_codes.device != q_codes.device:
        raise ValueError("q_codes and x_codes must share d and device")
    if d > MAX_D:
        raise ValueError(f"int8_dot takes d <= {MAX_D}, got {d}")
    out = torch.empty((B, N), dtype=torch.int32, device=x_codes.device)
    _build.check(_lib().int8_dot(q_codes.data_ptr(), x_codes.data_ptr(),
                                 out.data_ptr(), B, N, d, stream()),
                 "int8_dot")
    int8_dot_cuda.launches += 1
    return out


int8_dot_cuda.launches = 0
