"""Compute / communication overlap primitives (port of
``repro.distributed.collectives``).

``ring_allgather_matmul`` computes ``y = all_gather(x) @ w_local`` as P
ring steps: each step multiplies the resident x block into its rows of
the output while the next block travels one hop (``mesh.exchange``);
``allgather_matmul`` is the one-shot baseline. Each block product is
``models.layers.dot_f32`` (float32 accumulation and output, the
reference's ``preferred_element_type``).

Both take the mesh's local stack (``compat``): ``x`` [S, Bs, K], the row
blocks of the shards this process holds along ``axis``; ``w_local``
[K, N]. They return ``y`` [Bs * P, N], replicated, once.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dot_f32


def allgather_matmul(x_shard: torch.Tensor, w_local: torch.Tensor, mesh,
                     axis: str | None = None) -> torch.Tensor:
    """Baseline: ``y = all_gather(x) @ w_local``, the collective first."""
    x_full = mesh.all_gather(x_shard, axis=0, axis_name=axis)
    return dot_f32(x_full.reshape(-1, x_full.shape[-1]), w_local)


def ring_allgather_matmul(x_shard: torch.Tensor, w_local: torch.Tensor,
                          mesh, axis: str | None = None) -> torch.Tensor:
    """Ring-overlapped ``y = all_gather(x) @ w_local``: P steps, each
    receiving the block of the next coordinate (``(me + 1) mod P``), so
    after t hops a shard holds block ``me + t``."""
    S, bs = x_shard.shape[0], x_shard.shape[1]
    p = mesh.axis_size(axis)
    me = mesh.axis_index(axis).tolist()
    y = torch.zeros((S, bs * p, w_local.shape[-1]), dtype=torch.float32,
                    device=x_shard.device)
    xs = x_shard
    for t in range(p):
        for s in range(S):
            src = (me[s] + t) % p
            y[s, src * bs:(src + 1) * bs] = dot_f32(xs[s], w_local)
        if t + 1 < p:
            xs = mesh.exchange(xs, lambda c: (c + 1) % p, axis)
    return y[0]
