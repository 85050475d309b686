"""Progressive Greedy Search types (port of ``repro.core.pgs``).

This slice ports ``DiverseResult`` only; the per-query ``pgs`` driver comes
with the per-query drivers' slice (the batched engine runs Alg. 2 itself).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.progressive import SearchStats


class DiverseResult(NamedTuple):
    ids: np.ndarray      # int32[k], -1 padded
    scores: np.ndarray   # f32[k]
    total: float
    stats: SearchStats
