"""The device mesh of the sharded search (port of ``repro.compat``'s
``make_mesh`` and of the collectives ``repro.sharded_search`` runs under
``shard_map``).

Here the mesh is the P shards of one process on one device: every per-shard
tensor carries a leading shard axis of length P, and each collective is a
tensor operation over that axis. ``shard_map`` has no counterpart: a
function over the shard axis is written out over it (the lanes of all
shards step in one lockstep loop). Nor has ``ppermute``: the tournament
merge reads every shard's list itself (``kernels.ops.topk_tournament``). A
mesh of one process per card (NCCL through ``torch.distributed``) is later
work; it would supply the same two operations on the same leading-axis
layout, and a partner exchange for the tournament's rounds across cards.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """P shards on one device; ``axis_names`` names the shard axis."""
    shape: tuple
    axis_names: tuple
    device: torch.device

    @property
    def size(self) -> int:
        return int(self.shape[0])

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``jax.lax.psum`` over the shard axis (the result, replicated,
        once)."""
        return x.sum(dim=0, dtype=x.dtype)

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """``jax.lax.all_gather(x, axis=axis)``: the shards' blocks stacked
        at ``axis`` of one block (the result, replicated, once)."""
        return x.movedim(0, axis)


def make_mesh(shape, axis_names, device=None) -> LocalMesh:
    """A one-axis mesh of ``shape[0]`` shards on ``device`` (``cuda``
    unless given)."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != 1 or len(axis_names) != 1 or shape[0] < 1:
        raise ValueError("the mesh on one device has one axis of >= 1 "
                         f"shards, got shape {shape} axes {axis_names}")
    return LocalMesh(shape, axis_names, resolve_device(device))
