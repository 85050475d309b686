"""Power-of-two bucketing (port of ``repro.core.bucketing``).

Group sizes, prefix widths and capacities are rounded up to powers of two,
and variable-size lane groups are padded to a power-of-two length by
repeating a real lane index. PyTorch compiles nothing per shape, but the
engine keeps the same buckets so that its widths — which change div-A*'s
step accounting — and its ``SignatureLog`` match the reference.
"""
from __future__ import annotations

import numpy as np


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1)."""
    return 1 << max(0, (int(x) - 1)).bit_length()


def pow2_padded_indices(idx) -> np.ndarray:
    """Pad a non-empty lane-index vector to the next power-of-two length by
    repeating ``idx[0]``."""
    idx = np.asarray(idx)
    m = len(idx)
    if m == 0:
        raise ValueError("cannot pad an empty index group")
    g = next_pow2(m)
    return np.concatenate([idx, np.full(g - m, idx[0], idx.dtype)])


def pow2_group_sizes(b: int) -> list[int]:
    """All power-of-two group sizes up to next_pow2(b)."""
    top = next_pow2(b)
    return [1 << i for i in range(top.bit_length()) if (1 << i) <= top]
