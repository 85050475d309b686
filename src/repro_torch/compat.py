"""The device mesh of the sharded search and the training steps (port of
``repro.compat``'s ``make_mesh`` and of the collectives ``repro`` runs
under ``shard_map``).

Two meshes offer the same members, and every collective takes the *local
stack*: the blocks of the shards this process holds, on a leading axis.

* :class:`LocalMesh` is P shards of one process on one device: the local
  stack holds all P blocks, and each collective is a tensor operation over
  its leading axis. ``shard_map`` has no counterpart: a function over the
  shard axis is written out over it (the lanes of all shards step in one
  lockstep loop), and the tournament merge reads every shard's list itself
  (``kernels.ops.topk_tournament``).
* :class:`ProcessGroupMesh` is one shard (or one batch slice) per rank of a
  ``torch.distributed`` process group: the local stack holds one block, and
  each collective is the group's (``all_reduce``, ``all_gather``, and
  ``batch_isend_irecv`` for ``exchange``, the counterpart of ``ppermute``).

``psum`` / ``pmax`` / ``all_gather`` return the replicated result once
(no leading axis); ``exchange`` returns a local stack.

``ProcessGroupMesh.sub(t)`` is the mesh of its group's first ``t`` ranks,
whose sub-group every rank makes, those outside it included. A rank
outside a mesh holds no shard on it: its local stack is empty
(``local_size`` 0) and it takes part in none of the mesh's collectives.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device

#: the shard slots the mesh on one device offers: what ``device_count``
#: reports, the count every reference mesh check forces on the host
#: (``--xla_force_host_platform_device_count=4``)
LOCAL_DEVICE_COUNT = 4


def in_process_group() -> bool:
    """Whether this process has joined a default ``torch.distributed``
    group."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def device_count() -> int:
    """Counterpart of ``jax.device_count()``: the facade reads it to
    choose ``shards="auto"`` and its elastic targets. Inside a default
    process group it is the group's world size (one shard a rank);
    elsewhere the shard axis is virtual (P shards of one process on one
    card), so it is the fixed :data:`LOCAL_DEVICE_COUNT`, not the number
    of cards."""
    if in_process_group():
        import torch.distributed as dist
        return dist.get_world_size()
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

    @property
    def local_size(self) -> int:
        """Shards in this process's local stack: all of them."""
        return self.size

    def axis_size(self, axis_name: str | None = None) -> int:
        return self.size

    def psum(self, x: torch.Tensor, axis_name: str | None = None
             ) -> torch.Tensor:
        """``jax.lax.psum`` over the shard axis (the result, replicated,
        once)."""
        return x.sum(dim=0, dtype=x.dtype)

    def pmax(self, x: torch.Tensor, axis_name: str | None = None
             ) -> torch.Tensor:
        """``jax.lax.pmax`` over the shard axis."""
        return x.amax(dim=0)

    def all_gather(self, x: torch.Tensor, axis: int = 0,
                   axis_name: str | None = None) -> torch.Tensor:
        """``jax.lax.all_gather(x, axis=axis)``: the shards' blocks stacked
        at ``axis`` of one block (the result, replicated, once)."""
        return x.movedim(0, axis)

    def axis_index(self, axis_name: str | None = None) -> torch.Tensor:
        """``jax.lax.axis_index`` of each block of the local stack."""
        return torch.arange(self.size, device=self.device)

    def exchange(self, x: torch.Tensor, src: Callable[[int], int],
                 axis_name: str | None = None) -> torch.Tensor:
        """``jax.lax.ppermute``: shard s receives shard ``src(s)``'s block
        (``src`` a permutation of the shard indices)."""
        return x[[int(src(s)) for s in range(self.size)]]


def make_mesh(shape, axis_names, device=None) -> LocalMesh:
    """A one-axis mesh of ``shape[0]`` shards on ``device`` (``cuda``
    unless given)."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != 1 or len(axis_names) != 1 or shape[0] < 1:
        raise ValueError("the mesh on one device has one axis of >= 1 "
                         f"shards, got shape {shape} axes {axis_names}")
    return LocalMesh(shape, axis_names, resolve_device(device))


class ProcessGroupMesh:
    """A mesh of one block per rank of a ``torch.distributed`` group.

    Rank r of the group sits at the row-major coordinates of r in
    ``shape`` (as ``jax.make_mesh`` lays devices out); each axis has its
    own sub-groups, the lines of ranks along it. The backend is the
    caller's (``nccl`` with one card per rank; ``gloo`` on the CPU or with
    ranks sharing a card); nothing switches it. Gloo's ``all_reduce`` and
    ``all_gather`` take CUDA tensors as they are, its point-to-point ops do
    not (torch 2.11 aborts the process: its TCP pair writes the device
    pointer), so ``exchange`` stages a CUDA tensor through host memory in
    ``_to_wire``, which counts the bytes (``staged_bytes``).
    ``collective_s`` adds up the wall seconds spent inside the collectives,
    ``gathered_bytes`` the bytes ``all_gather`` brought to this rank, and
    ``broadcast_s`` the seconds inside ``broadcast_object``.

    ``sub(t)`` is the mesh of the group's first ``t`` ranks (``world`` is
    the mesh it was cut from). A rank outside it holds no shard there
    (``member`` False, ``rank`` -1, ``local_size`` 0).
    """

    def __init__(self, shape, axis_names, group=None, device=None, *,
                 world: "ProcessGroupMesh | None" = None,
                 ranks: list | None = None):
        import torch.distributed as dist

        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or min(self.shape) < 1:
            raise ValueError(f"mesh shape {self.shape} for axes "
                             f"{self.axis_names}")
        self.group = group if group is not None else dist.group.WORLD
        #: the mesh this one was cut from (``sub``); itself when whole
        self.world = world if world is not None else self
        self.member = self.group is not dist.GroupMember.NON_GROUP_MEMBER
        self.ranks = (dist.get_process_group_ranks(self.group) if self.member
                      else list(ranks))
        if len(self.ranks) != math.prod(self.shape):
            raise ValueError(f"a mesh of shape {self.shape} needs "
                             f"{math.prod(self.shape)} ranks, the group has "
                             f"{len(self.ranks)}")
        self.rank = dist.get_rank(self.group) if self.member else -1
        self.backend = dist.get_backend(self.world.group)
        self.device = resolve_device(device)
        self.coords = (tuple(int(c) for c in np.unravel_index(self.rank,
                                                              self.shape))
                       if self.member else None)
        self._subs: dict = {}
        self.staged_bytes = 0
        self.gathered_bytes = 0
        self.collective_s = 0.0
        self.broadcast_s = 0.0
        # one sub-group per line of ranks along each axis; every rank makes
        # every group, in the same order (``new_group``'s contract), a rank
        # outside the mesh (``sub``) too
        self._axis_groups = {}
        for ax, name in enumerate(self.axis_names):
            if len(self.shape) == 1:
                self._axis_groups[name] = (self.group, self.ranks)
                continue
            grid = np.arange(self.size).reshape(self.shape)
            for line in np.moveaxis(grid, ax, -1).reshape(-1, self.shape[ax]):
                members = [self.ranks[r] for r in line]
                g = dist.new_group(members)
                if self.rank in line:
                    self._axis_groups[name] = (g, members)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def local_size(self) -> int:
        """Blocks in this rank's local stack: one, none outside the
        mesh."""
        return int(self.member)

    def sub(self, t: int, shape=None, axis_names=None
            ) -> "ProcessGroupMesh":
        """The mesh of this group's first ``t`` ranks: one axis (this
        mesh's), or ``shape`` over ``axis_names`` (t ranks in all). Its
        groups are made on first use by ``dist.new_group``, which every
        rank of the group must call in the same order, those outside the
        sub-group included; later calls return the same mesh."""
        import torch.distributed as dist

        shape = (t,) if shape is None else tuple(int(n) for n in shape)
        axis_names = self.axis_names if axis_names is None else tuple(
            axis_names)
        if (len(self.shape) != 1 or not 1 <= t <= self.size
                or math.prod(shape) != t):
            raise ValueError(f"no sub-mesh of {t} ranks (shape {shape}) in "
                             f"a mesh of shape {self.shape}")
        if t == self.size and shape == self.shape:
            return self
        key = (shape, axis_names)
        if key not in self._subs:
            members = self.ranks[:t]
            group = self.group if t == self.size else dist.new_group(members)
            self._subs[key] = ProcessGroupMesh(
                shape, axis_names, group, self.device, world=self,
                ranks=members)
        return self._subs[key]

    def axis_size(self, axis_name: str | None = None) -> int:
        return self.shape[self._axis(axis_name)]

    def _axis(self, axis_name: str | None) -> int:
        if axis_name is None:
            if len(self.shape) != 1:
                raise ValueError(f"a mesh of axes {self.axis_names} needs "
                                 "the collective's axis_name")
            return 0
        return self.axis_names.index(axis_name)

    def _line(self, axis_name):
        return self._axis_groups[self.axis_names[self._axis(axis_name)]]

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor the point-to-point ops take: a host copy of a CUDA
        tensor under gloo (its bytes counted), else ``x`` itself
        (contiguous)."""
        if self.backend == "gloo" and x.is_cuda:
            self.staged_bytes += x.numel() * x.element_size()
            return x.cpu()
        return x.contiguous()

    def _one(self, x: torch.Tensor) -> torch.Tensor:
        if not self.member:
            raise RuntimeError("this rank holds no shard on the mesh of "
                               f"ranks {self.ranks}: it joins none of its "
                               "collectives")
        if x.shape[0] != 1:
            raise ValueError("a process-group mesh's local stack holds one "
                             f"block, got a leading axis of {x.shape[0]}")
        return x[0]

    def _reduce(self, x, op, axis_name):
        import torch.distributed as dist

        t0 = time.perf_counter()
        group, _ = self._line(axis_name)
        out = self._one(x).clone()     # the reduction writes its input
        dist.all_reduce(out, op=op, group=group)
        self.collective_s += time.perf_counter() - t0
        return out

    def psum(self, x: torch.Tensor, axis_name: str | None = None
             ) -> torch.Tensor:
        """``jax.lax.psum`` along ``axis_name`` of the rank's block
        (``x`` [1, ...]): the sum, replicated, once."""
        import torch.distributed as dist
        return self._reduce(x, dist.ReduceOp.SUM, axis_name)

    def pmax(self, x: torch.Tensor, axis_name: str | None = None
             ) -> torch.Tensor:
        """``jax.lax.pmax`` along ``axis_name``."""
        import torch.distributed as dist
        return self._reduce(x, dist.ReduceOp.MAX, axis_name)

    def all_gather(self, x: torch.Tensor, axis: int = 0,
                   axis_name: str | None = None) -> torch.Tensor:
        """``jax.lax.all_gather(x, axis=axis)`` along ``axis_name``: the
        blocks of the ranks on this rank's line, in their order, stacked at
        ``axis`` of one block."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        group, members = self._line(axis_name)
        block = self._one(x).contiguous()
        parts = [torch.empty_like(block) for _ in members]
        dist.all_gather(parts, block, group=group)
        out = torch.stack(parts).movedim(0, axis)
        self.gathered_bytes += out.numel() * out.element_size()
        self.collective_s += time.perf_counter() - t0
        return out

    def axis_index(self, axis_name: str | None = None) -> torch.Tensor:
        """This rank's coordinate along ``axis_name``, as the local stack's
        one-element index."""
        return torch.tensor([self.coords[self._axis(axis_name)]],
                            device=self.device)

    def exchange(self, x: torch.Tensor, src: Callable[[int], int],
                 axis_name: str | None = None) -> torch.Tensor:
        """``jax.lax.ppermute`` along ``axis_name``: this rank receives the
        block of coordinate ``src(me)`` and sends its own to the rank that
        receives from it (``src`` a permutation of the coordinates), one
        ``batch_isend_irecv`` pair."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        ax = self._axis(axis_name)
        group, members = self._line(axis_name)
        me, p = self.coords[ax], self.shape[ax]
        frm = int(src(me))
        to = [c for c in range(p) if int(src(c)) == me]
        if len(to) != 1:
            raise ValueError("exchange needs a permutation of the "
                             f"{p} coordinates")
        if frm == me and to[0] == me:
            out = x.clone()
        else:
            wire = self._to_wire(x)
            buf = torch.empty_like(wire)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, wire, members[to[0]], group),
                dist.P2POp(dist.irecv, buf, members[frm], group)])
            for r in reqs:
                r.wait()
            out = buf.to(x.device)
        self.collective_s += time.perf_counter() - t0
        return out

    def broadcast_object(self, obj, src: int = 0):
        """``obj`` of group rank ``src``, on every rank (pickled)."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[src], group=self.group)
        self.broadcast_s += time.perf_counter() - t0
        return box[0]

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.group)


def make_process_mesh(shape, axis_names, *, group=None, backend=None,
                      init_method=None, rank=None, world_size=None,
                      timeout_s: float | None = None,
                      device=None) -> ProcessGroupMesh:
    """A :class:`ProcessGroupMesh` of ``shape`` over ``group`` (the default
    group unless given). Where no default group exists yet it is made here
    from ``(backend, init_method, rank, world_size)``, all four required:
    the backend is the caller's choice. ``device`` is where the rank's
    tensors live (``cuda`` unless given)."""
    import torch.distributed as dist

    if group is None and not dist.is_initialized():
        if None in (backend, init_method, rank, world_size):
            raise ValueError("no process group yet: pass backend, "
                             "init_method, rank and world_size")
        kw = {}
        if timeout_s is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(backend, init_method=init_method,
                                rank=int(rank), world_size=int(world_size),
                                **kw)
    return ProcessGroupMesh(shape, axis_names, group, device)
