"""Tensor parallelism over a mesh's ``model`` axis (no reference module:
GSPMD partitions the reference's one program by its sharding rules, and a
rank here runs its share of that program with explicit collectives).

The operators are Megatron's, each an autograd ``Function`` whose
collective goes through the mesh (``compat.ProcessGroupMesh.psum`` /
``pmax`` / ``all_gather``; gloo's point-to-point ops abort on CUDA
tensors, so none is used):

* :func:`copy_to_model`: the identity forward, a psum of the gradient
  backward. It goes before a column-parallel product, whose input is
  replicated and whose gradient each rank holds only a share of.
* :func:`reduce_from_model`: a psum forward, the identity backward. It goes
  after a row-parallel product, whose output each rank holds a share of.
* :func:`gather_from_model`: an all-gather along a dimension forward, the
  rank's slice of the gradient backward.
* :func:`scatter_from_model`: a reduce-scatter along a dimension, a psum
  forward followed by the rank's block, and an all-gather of the gradient
  backward. It goes after a product whose input rows are split (RG-LRU's
  ``w_r`` / ``w_i``): each rank holds a partial sum of every output
  channel and keeps its own channels; each channel's gradient, which one
  rank holds, reaches the partial sums of every rank.
* :func:`sum_over_model`: a psum forward and a psum of the gradient
  backward. It sums a statistic that every rank's channels consume (the
  gated RMSNorm's sum of squares over Mamba-2's split width): each rank
  holds the gradient of its own channels' use of the sum only, and the
  sum's gradient is the total over the ranks. It is
  ``copy_to_model(reduce_from_model(x))``.
* :func:`vocab_parallel_nll`: the cross entropy of vocab-sharded logits.

``torch.distributed.nn.functional.all_reduce`` is not one of them: its
backward all-reduces again, which multiplies a replicated leaf's gradient
by the axis size. Every psum here runs in float32: a bf16 tensor is cast
up and its sum rounded once, and where the sum has one nonzero term a
rank (the vocab lookup, the experts' contributions) it is exact.

:class:`ModelParallel` is what a rank's decoder holds of the mesh:
``models.model.shard`` sets it on the module (``params.mp``), and the
layers read which of the rules' parameter groups are split.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import MODEL, axis_sizes, param_cuts

F32 = torch.float32


def model_axis(mesh) -> int:
    """The size of ``mesh``'s ``model`` axis (1 without one)."""
    return 1 if mesh is None else axis_sizes(mesh).get(MODEL, 1)


class ModelParallel:
    """A rank's place on the ``model`` axis of ``mesh`` (``size`` m, this
    rank's coordinate ``index``) and which parameter groups the rules of
    ``distributed.sharding.param_spec_tree`` split over it for ``cfg``
    (``cuts``, by parameter name: how each parameter is cut from its whole
    leaf, ``sharding.param_cuts``):
    the vocabulary (``embed`` /
    ``lm_head``), the q heads (``wq`` / ``wo`` of every attention: the
    decoders' ``attn``, whisper's ``attn``, ``self_attn`` and
    ``cross_attn``), the kv heads (``wk`` / ``wv``), the MLP's hidden
    width, the MoE's experts, Mamba-2's heads (``ssm``) and the RG-LRU's
    width (``lru``)."""

    def __init__(self, cfg, mesh):
        self.mesh = mesh
        self.cuts = param_cuts(cfg, mesh)
        self.size = axis_sizes(mesh)[MODEL]
        self.index = mesh.coords[mesh.axis_names.index(MODEL)]

        def split(suffix: str) -> bool:
            return any(name.endswith(suffix) and cut.split
                       for name, cut in self.cuts.items())

        self.vocab = self.cuts["embed"].split
        self.heads = split("attn.wq")
        self.kv = split("attn.wk")
        self.mlp = split(".mlp.wg") or split(".mlp.w1")
        self.experts = split(".moe.wg")
        self.ssm = split(".w_in")
        self.lru = split(".w_gate")
        h, kv = cfg.num_heads, cfg.num_kv_heads
        self.local_heads = h // self.size if self.heads else h
        #: the kv head each local q head reads: its global q index over
        #: the q heads a kv head serves, less the first local kv head
        first_q = self.index * self.local_heads if self.heads else 0
        kv_of = [(first_q + j) // (h // kv) for j in range(self.local_heads)
                 ] if kv else []         # ssm: no attention
        base = self.index * (kv // self.size) if self.kv else 0
        self.kv_of = [k - base for k in kv_of]

    def kv_block(self) -> tuple[int, int] | None:
        """(first, count) when the local q heads read the kv heads
        ``[first, first + count)`` in equal groups, in order (then a
        narrow of the kv tensors is a grouped-query layout); else None."""
        ks = self.kv_of
        first, count = ks[0], ks[-1] - ks[0] + 1
        if len(ks) % count:
            return None
        g = len(ks) // count
        if ks != [first + i // g for i in range(len(ks))]:
            return None
        return first, count


def _psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the model axis, in float32, in x's dtype."""
    return mesh.psum(x.to(F32)[None], MODEL).to(x.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _psum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.index = mesh.coords[mesh.axis_names.index(MODEL)]
        parts = mesh.all_gather(x.contiguous()[None], axis=0,
                                axis_name=MODEL)
        return torch.cat(list(parts), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        m = axis_sizes(mesh)[MODEL]
        ctx.mesh, ctx.dim = mesh, dim
        n = x.shape[dim] // m
        index = mesh.coords[mesh.axis_names.index(MODEL)]
        return _psum(x, mesh).narrow(dim, index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = ctx.mesh.all_gather(g.contiguous()[None], axis=0,
                                    axis_name=MODEL)
        return torch.cat(list(parts), dim=ctx.dim), None, None


def copy_to_model(x: torch.Tensor, mp: ModelParallel | None) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model axis."""
    if mp is None or mp.size == 1:
        return x
    return _Copy.apply(x, mp.mesh)


def reduce_from_model(x: torch.Tensor, mp: ModelParallel | None
                      ) -> torch.Tensor:
    """The sum of every model rank's ``x``; the gradient passed to each."""
    if mp is None or mp.size == 1:
        return x
    return _Reduce.apply(x, mp.mesh)


def gather_from_model(x: torch.Tensor, mp: ModelParallel | None,
                      dim: int = -1) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim`` in rank order."""
    if mp is None or mp.size == 1:
        return x
    return _Gather.apply(x, mp.mesh, dim % x.dim())


def scatter_from_model(x: torch.Tensor, mp: ModelParallel | None,
                       dim: int = -1) -> torch.Tensor:
    """The rank's block along ``dim`` of the sum of every model rank's
    ``x`` (float32); the gradient all-gathered back to the whole ``x``."""
    if mp is None or mp.size == 1:
        return x
    return _Scatter.apply(x, mp.mesh, dim % x.dim())


def sum_over_model(x: torch.Tensor, mp: ModelParallel | None
                   ) -> torch.Tensor:
    """The sum of every model rank's ``x``, its gradient summed too."""
    return copy_to_model(reduce_from_model(x, mp), mp)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       mp: ModelParallel) -> torch.Tensor:
    """Each row's ``logsumexp(logits) - logits[label]`` from this rank's
    vocab block ``logits`` [..., V / m] (float32; labels [...] global
    ids, any value where a row is masked): the row maxima's pmax, the psum
    of the shifted sums of exponentials, and the psum of the label's logit,
    which one rank holds (the others add zeros, so that sum is exact).
    The maxima carry no gradient: the result does not depend on them."""
    vl = logits.shape[-1]
    top = mp.mesh.pmax(logits.detach().amax(-1)[None], MODEL)
    total = reduce_from_model(
        torch.exp(logits - top[..., None]).sum(-1), mp)
    local = labels - mp.index * vl
    mine = (local >= 0) & (local < vl)
    picked = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])
    picked = reduce_from_model(torch.where(mine, picked[..., 0], 0.0), mp)
    return top + torch.log(total) - picked


class DataRanks:
    """A rank's place on the batch axes of ``mesh`` (``pod`` and ``data``,
    the reference's ``_bat``): ``size`` D ranks, this rank's row-major
    ``index`` over them. A global batch's rows are split into D contiguous
    blocks in that order (block ``index`` is this rank's)."""

    def __init__(self, mesh):
        sizes = axis_sizes(mesh)
        coords = dict(zip(mesh.axis_names, mesh.coords))
        self.mesh = mesh
        self.axes = tuple(a for a in ("pod", "data") if a in sizes)
        self.size, self.index = 1, 0
        for a in self.axes:
            self.size *= sizes[a]
            self.index = self.index * sizes[a] + coords[a]

    def rows(self, n: int) -> slice:
        """This rank's block of ``n`` global rows."""
        if n % self.size:
            raise ValueError(f"a global batch of {n} rows does not split "
                             f"over {self.size} data ranks")
        b = n // self.size
        return slice(self.index * b, (self.index + 1) * b)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every data rank's ``x`` (no gradient)."""
        for a in reversed(self.axes):
            x = self.mesh.psum(x[None], a)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``x`` stacked on a new leading axis, in rank
        order: [D, ...]."""
        for a in reversed(self.axes):
            x = self.mesh.all_gather(x[None], axis=0, axis_name=a)
            if a != self.axes[-1]:
                x = x.flatten(0, 1)
        return x

    def cat(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``x`` [b, ...] concatenated: [D b, ...]."""
        return self.all_gather(x).flatten(0, 1)


def data_ranks(mesh) -> DataRanks | None:
    """The batch axes of a process-group ``mesh`` when they hold more than
    one rank; None otherwise (no mesh, one device, or one data rank)."""
    if mesh is None or getattr(mesh, "coords", None) is None:
        return None
    ranks = DataRanks(mesh)
    return ranks if ranks.size > 1 else None
