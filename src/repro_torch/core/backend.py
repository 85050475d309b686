"""Backend types (port of ``repro.core.backend``).

This slice ports ``LaneRequest`` only: what a backend needs to serve one
request. The ``LaneBackend`` / ``RescalableBackend`` protocols come with the
serving front door's slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(eq=False)
class LaneRequest:
    """One diverse-search request, the way a backend sees it.

    ``ef`` <= 0 means "backend default"; ``max_K`` caps the progressive
    candidate budget (the paper's N/A guard). Compares by identity.
    """
    q: np.ndarray
    k: int
    eps: float
    ef: int = 0
    method: str = "pss"
    max_K: int | None = None
