"""Progressive search types (port of ``repro.core.progressive``).

This slice ports ``SearchStats`` only; the per-query ``ProgressiveDriver``
comes with the per-query drivers' slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SearchStats:
    expansions: int = 0
    growths: int = 0
    search_calls: int = 0
    div_calls: int = 0
    certified: bool = False
    exhausted: bool = False
    K_final: int = 0
