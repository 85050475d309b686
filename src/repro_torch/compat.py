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

#: the shard slots the mesh on one device offers: what ``device_count``
#: reports, the count every reference mesh check forces on the host
#: (``--xla_force_host_platform_device_count=4``)
LOCAL_DEVICE_COUNT = 4


def device_count() -> int:
    """Counterpart of ``jax.device_count()`` for the mesh on one device:
    the facade reads it to choose ``shards="auto"`` and its elastic targets.
    The shard axis is virtual here (P shards of one process on one card),
    so this is the fixed :data:`LOCAL_DEVICE_COUNT`, not the number of
    cards. A mesh of one process per card (ROADMAP queue 1 D) replaces it
    with the process group's world size."""
    return LOCAL_DEVICE_COUNT


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
