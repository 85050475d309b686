"""CUDA kernel: the tournament merge of the sharded search
(``csrc/topk_merge.cu``).

Replaces the Pallas kernel ``topk_merge_pallas``
(``src/repro/kernels/topk_merge.py:53``), which the reference vmaps over the
lanes of each butterfly round (``src/repro/sharded_search/search.py:304``).
Here one launch merges every row of a round: rows of two runs sorted by
(score desc, id asc), each of length L, give the first L of their merge.

Bound on the card: 24 bytes an output position (two pairs read, one
written), so bytes; at the path's shapes (64 rows, L <= 4096) the launch
bounds it. Each thread ranks one input entry by binary search in the other
run, so no padding to a power of two and no shared-memory cap on L. The
plain version is ``kernels.ref.topk_merge``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda, stream


def _lib():
    lib = _build.load("topk_merge")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_merge.argtypes = [p, p, p, p, p, p, i, i, p]
        lib.topk_merge.restype = i
        lib._typed = True
    return lib


def topk_merge_cuda(ids_a: torch.Tensor, scores_a: torch.Tensor,
                    ids_b: torch.Tensor, scores_b: torch.Tensor):
    """First L of the merge of each row's two sorted runs [R, L] on the
    card -> (ids int32[R, L], scores f32[R, L])."""
    for name, t, dtype in (("ids_a", ids_a, torch.int32),
                           ("scores_a", scores_a, torch.float32),
                           ("ids_b", ids_b, torch.int32),
                           ("scores_b", scores_b, torch.float32)):
        check_cuda(name, t, dtype, 2)
        if t.shape != ids_a.shape or t.device != ids_a.device:
            raise ValueError("topk_merge: the four inputs must share shape "
                             "and device")
    R, L = ids_a.shape
    ids = torch.empty_like(ids_a)
    scores = torch.empty_like(scores_a)
    _build.check(_lib().topk_merge(
        ids_a.data_ptr(), scores_a.data_ptr(), ids_b.data_ptr(),
        scores_b.data_ptr(), ids.data_ptr(), scores.data_ptr(), R, L,
        stream()), "topk_merge")
    topk_merge_cuda.launches += 1
    return ids, scores


topk_merge_cuda.launches = 0
