"""CUDA kernels: the tournament merge of the sharded search
(``csrc/topk_merge.cu``).

Replaces the Pallas kernel ``topk_merge_pallas``
(``src/repro/kernels/topk_merge.py:53``), which the reference vmaps over the
lanes of each butterfly round (``src/repro/sharded_search/search.py:304``).

- ``topk_tournament_cuda``: the whole tournament in one launch. From the
  shards' runs [P, B, L] it writes the [B, L] rows shard 0 holds after
  log2 P butterfly rounds, each lane's block reading every run itself, so
  no partner exchange. Bound: 8 B L (P + 1) bytes, so at the path's shapes
  the launch bounds it. The plain version is ``kernels.ref.topk_tournament``.
- ``topk_merge_cuda``: one round's pairwise merge over every row: rows of
  two runs sorted by (score desc, id asc), each of length L, give the first
  L of their merge. Bound: 24 bytes an output position. The plain version
  is ``kernels.ref.topk_merge``.

Both rank each input entry by binary search in the other runs, so there is
no padding to a power of two. Launches of both count under ``topk_merge``
(``topk_merge_cuda.launches``).
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
        lib.topk_tournament.argtypes = [p, p, p, p, i, i, i, p]
        lib.topk_tournament.restype = i
        lib._typed = True
    return lib


def topk_merge_cuda(ids_a: torch.Tensor, scores_a: torch.Tensor,
                    ids_b: torch.Tensor, scores_b: torch.Tensor):
    """First L of the merge of each row's two sorted runs [R, L] on the
    card -> (ids int32[R, L], scores f32[R, L]). Scores must not be NaN
    (the kernel's comparisons order no NaN; the search's scores are
    similarities and its padding -inf); this is not checked."""
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


def topk_tournament_cuda(ids: torch.Tensor, scores: torch.Tensor):
    """Shard 0's rows after the butterfly over the shards' sorted runs
    ids int32 / scores f32 [P, B, L], P a power of two >= 2, on the card,
    in one launch -> (ids int32[B, L], scores f32[B, L]). Scores must not
    be NaN, as for ``topk_merge_cuda``; this is not checked."""
    check_cuda("ids", ids, torch.int32, 3)
    check_cuda("scores", scores, torch.float32, 3)
    if scores.shape != ids.shape or scores.device != ids.device:
        raise ValueError("topk_tournament: ids and scores must share shape "
                         "and device")
    P, B, L = ids.shape
    if P < 2 or P & (P - 1):
        raise ValueError(f"topk_tournament needs a power of two >= 2 of "
                         f"runs, got P = {P}")
    out_ids = torch.empty((B, L), dtype=torch.int32, device=ids.device)
    out_scores = torch.empty((B, L), dtype=torch.float32, device=ids.device)
    _build.check(_lib().topk_tournament(
        ids.data_ptr(), scores.data_ptr(), out_ids.data_ptr(),
        out_scores.data_ptr(), P, B, L, stream()), "topk_tournament")
    topk_merge_cuda.launches += 1
    return out_ids, out_scores
