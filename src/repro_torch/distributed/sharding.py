"""Sharding rules: every param / cache / batch leaf's partition spec (port
of ``repro.distributed.sharding``).

The rules are the reference's, name for name, over the reference's
parameter layout: the port's parameters (``blocks.{i}.<path>``) stacked
as ``models.model.stack`` stacks them, each stack on leading axes. A spec
is a tuple with one entry per dimension: None (replicated), an axis name,
or a tuple of axis names (the dimension split over their product,
row-major), as a ``PartitionSpec`` lists them.

Baseline policy (deliberately simple and always divisibility-safe):

  * batch / data parallel over ("pod", "data") for all activations;
  * Megatron-style tensor parallel over "model" for MLP hidden, MoE
    experts, SSM channels, RG-LRU width, and the vocab dim (when divisible
    by the model-axis size);
  * attention q-heads shard over "model" only when the head count divides
    the axis; kv projections shard at kv-head granularity when divisible,
    else stay replicated.

``to_named`` (placing a tree on a JAX mesh) has no counterpart: a rank
keeps its slice of a leaf (``shard_leaf``) and the whole leaf comes back
by gathering the slices (``gather_leaf``). A mesh here is anything with
``shape`` (a tuple, or a dict of axis sizes) and ``axis_names``.
``param_specs`` gives the spec of each parameter of the port's module (by
its name), ``local_shape`` a rank's slice's shape and ``on_axis`` whether
a spec splits a dimension over an axis.

GSPMD computes the one-process function whatever the placement; a rank
here must hold what its share of the work reads. :func:`param_cut` is how
a rank's slice of a parameter is cut from the whole leaf and gathered back
(:class:`Cut`), the one helper every cut and gather of a parameter goes
through (``models.model.shard`` / ``whole``, the optimizer's moments,
``elastic.reshard_tree``). It is the spec's cut, except for Mamba-2's
concatenated leaves: ``w_in`` [D, z Di | x Di | B N | C N | dt H] and
``conv_w`` / ``conv_b`` [.., x Di | B N | C N] are cut part by part, each
rank taking its heads' block of z, x and dt and every column of B and C
(one group, read by every head). Where the heads do not divide the model
axis, or the rules keep ``w_in`` or the conv whole, the whole SSM group
stays whole on every rank.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig

MODEL = "model"


def axis_sizes(mesh) -> dict[str, int]:
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(n) for a, n in shape.items()}
    return {a: int(n) for a, n in zip(mesh.axis_names, shape)}


def _bat(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _div(n: int, m: int) -> bool:
    return n % m == 0


def _walk(tree, fn, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts, the same nesting."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_layout(params) -> dict:
    """The reference's params tree of leaf shapes (``torch.Size``) for the
    port's parameters (a module, on any device or ``meta``), each stack's
    tensors on leading axes as ``models.model.stack`` lays them; a tree of
    nested dicts (of tensors, arrays or shapes) is returned as its
    shapes."""
    if isinstance(params, dict):
        return _walk(params, lambda _, leaf: torch.Size(
            leaf if isinstance(leaf, torch.Size) else leaf.shape))
    stacks: dict[tuple, dict[tuple, torch.Size]] = {}
    for name, p in params.named_parameters():
        path = tuple(name.split("."))
        axes = 0
        while path[1 + axes:] and path[1 + axes].isdigit():
            axes += 1
        key = (path[0],) + path[1 + axes:]
        idx = tuple(int(i) for i in path[1:1 + axes])
        stacks.setdefault(key, {})[idx] = p.shape
    out: dict = {}
    for path, parts in stacks.items():
        lead = tuple(max(i[a] for i in parts) + 1
                     for a in range(len(next(iter(parts)))))
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.Size(lead + tuple(next(iter(parts.values()))))
    return out


def param_spec_tree(cfg: ModelConfig, params: Any, mesh, fsdp: bool = False):
    """The spec of every leaf of ``param_layout(params)``, the same tree.

    ``fsdp``: additionally shard every large weight over the data axes on
    a free (unsharded, divisible) dim, ZeRO-3 style."""
    sizes = axis_sizes(mesh)
    ms = sizes["model"]
    bat = _bat(mesh)
    ds = math.prod(sizes[a] for a in bat)
    h, kv = cfg.num_heads, cfg.num_kv_heads

    def fsdpify(spec: tuple, shape) -> tuple:
        if not fsdp or math.prod(shape) < (1 << 20):
            return spec
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (dim, sp) in enumerate(zip(shape, parts)):
            if sp is None and dim % ds == 0 and dim >= ds:
                parts[i] = bat if len(bat) > 1 else bat[0]
                return tuple(parts)
        return spec

    def leaf_spec(path, shape) -> tuple:
        name = path[-1]
        joined = "/".join(path)
        rank = len(shape)

        def last_dims(tail: tuple) -> tuple:
            return (None,) * (rank - len(tail)) + tuple(tail)

        def on(cond, tail, other):
            return last_dims(tail) if cond else last_dims(other)

        if name == "embed":
            return ("model", None) if _div(shape[0], ms) else (None, None)
        if name == "lm_head":
            return (None, "model") if _div(shape[1], ms) else (None, None)
        if name == "dec_pos":
            return (None, None)
        if name == "wq":
            return on(_div(h, ms), (None, "model"), (None, None))
        if name == "bq":
            return on(_div(h, ms), ("model",), (None,))
        if name in ("wk", "wv"):
            return on(_div(kv, ms), (None, "model"), (None, None))
        if name in ("bk", "bv"):
            return on(_div(kv, ms), ("model",), (None,))
        if name == "wo":
            return on(_div(h, ms), ("model", None), (None, None))
        if name == "wr":
            return last_dims((None, None))
        if "moe" in joined and name in ("wg", "wu", "wd"):
            return on(_div(cfg.num_experts, ms), ("model", None, None),
                      (None,) * 3)
        if name in ("wg", "wu", "w1"):
            return on(_div(shape[-1], ms), (None, "model"), (None, None))
        if name == "b1":
            return on(_div(shape[-1], ms), ("model",), (None,))
        if name in ("wd", "w2"):
            return on(_div(shape[-2], ms), ("model", None), (None, None))
        if name == "b2":
            return last_dims((None,))
        if name == "w_in":
            return on(_div(shape[-1], ms), (None, "model"), (None, None))
        if name in ("conv_w", "conv_b", "norm_scale"):
            if not _div(shape[-1], ms):
                return last_dims((None,) * (1 if name != "conv_w" else 2))
            return last_dims(("model",) if name != "conv_w"
                             else (None, "model"))
        if name in ("A_log", "dt_bias", "D_skip"):
            return on(_div(shape[-1], ms), ("model",), (None,))
        if name == "w_out":
            return on(_div(shape[-2], ms), ("model", None), (None, None))
        if name in ("w_gate", "w_branch"):
            return on(_div(shape[-1], ms), (None, "model"), (None, None))
        if name in ("w_r", "w_i"):
            return on(_div(shape[-2], ms), ("model", None), (None, None))
        if name in ("b_r", "b_i", "lam"):
            return on(_div(shape[-1], ms), ("model",), (None,))
        return (None,) * rank

    return _walk(param_layout(params),
                 lambda path, shape: fsdpify(leaf_spec(path, shape), shape))


def param_specs(cfg: ModelConfig, mesh) -> dict[str, tuple]:
    """{parameter name of the port's module: its spec}, each the spec of
    its stacked leaf in :func:`param_spec_tree` less the stacked axes'
    entries. The rules read the whole shapes (``abstract_params``), so a
    rank's sharded module gives the same answers."""
    from repro_torch.models.model import abstract_params

    params = abstract_params(cfg)
    tree = param_spec_tree(cfg, param_layout(params), mesh)
    out = {}
    for name, _ in params.named_parameters():
        path = tuple(name.split("."))
        axes = 0
        while path[1 + axes:] and path[1 + axes].isdigit():
            axes += 1
        node = tree
        for key in (path[0],) + path[1 + axes:]:
            node = node[key]
        out[name] = tuple(node[axes:])
    return out


def on_axis(spec: tuple, axis: str = "model") -> bool:
    """Whether ``spec`` splits a dimension over ``axis``."""
    return any(axis in _entry_axes(e) for e in spec)


def local_shape(shape, spec: tuple, mesh, parts=None) -> torch.Size:
    """The shape of a rank's slice of a leaf of ``shape`` under ``spec``
    (:func:`shard_leaf`'s), or cut part by part along its last dimension
    (``parts``, :class:`Cut`'s)."""
    sizes = axis_sizes(mesh)
    if parts is not None:
        m = sizes[MODEL]
        return torch.Size(tuple(shape[:-1]) + (
            sum(w // m if split else w for w, split in parts),))
    return torch.Size(n // math.prod(sizes[a] for a in _entry_axes(e))
                      for n, e in zip(shape, tuple(spec) + (None,) * (
                          len(shape) - len(spec))))


#: the Mamba-2 block's parameters, split over the model axis together
SSM_LEAVES = ("w_in", "conv_w", "conv_b", "norm_scale", "A_log", "dt_bias",
              "D_skip", "w_out")


def ssm_split(cfg: ModelConfig, m: int) -> bool:
    """Whether a rank runs H / m of the Mamba-2 heads at a model axis of
    ``m``: the heads divide m and the rules split ``w_in`` and the conv
    (their last dimensions divide m)."""
    di = cfg.ssm_expand * cfg.d_model
    n, h = cfg.ssm_state, di // max(cfg.ssm_headdim, 1)
    return (m > 1 and h % m == 0 and (2 * di + 2 * n + h) % m == 0
            and (di + 2 * n) % m == 0)


class Cut:
    """How a rank's slice of one parameter is cut from the whole leaf and
    gathered back: by ``spec`` (:func:`shard_leaf` / :func:`gather_leaf`),
    or, with ``parts`` ((width, split), ...) along the last dimension, part
    by part: a split part gives the rank its block of width / m (``m``,
    the model axis's size, at the rank's coordinate), a part that is not
    split is whole on every rank. ``split``: whether the rank holds less
    than the whole leaf."""

    def __init__(self, spec: tuple, parts=None, m: int = 1):
        self.spec, self.parts, self.m = tuple(spec), parts, m

    @property
    def split(self) -> bool:
        return on_axis(self.spec)

    def local_shape(self, shape, mesh) -> torch.Size:
        return local_shape(shape, self.spec, mesh, self.parts)

    def shard(self, t: torch.Tensor, mesh) -> torch.Tensor:
        """This rank's slice of the whole leaf ``t``."""
        if self.parts is None:
            return shard_leaf(t, self.spec, mesh)
        m, i = self.m, mesh.coords[mesh.axis_names.index(MODEL)]
        pieces, off = [], 0
        for w, split in self.parts:
            p = t.narrow(-1, off, w)
            pieces.append(p.narrow(-1, i * (w // m), w // m) if split else p)
            off += w
        return torch.cat(pieces, -1).contiguous()

    def gather(self, t: torch.Tensor, mesh) -> torch.Tensor:
        """The whole leaf from every model rank's slice ``t`` (every model
        rank calls it): the inverse of :meth:`shard`, bit for bit."""
        if self.parts is None:
            return gather_leaf(t, self.spec, mesh)
        m = self.m
        every = mesh.all_gather(t.contiguous()[None], axis=0,
                                axis_name=MODEL)
        pieces, off = [], 0
        for w, split in self.parts:
            w = w // m if split else w
            pieces.append(torch.cat(list(every.narrow(-1, off, w)), -1)
                          if split else t.narrow(-1, off, w))
            off += w
        return torch.cat(pieces, -1).contiguous()

    def squares(self, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(the float32 sum of squares of the entries of the rank's slice
        ``g`` that are split over the model axis, and of those it holds
        whole): a gradient's share of the whole tree's squared norm is the
        first summed over the model ranks, plus the second once."""
        sq = torch.square(g.to(torch.float32))
        zero = sq.new_zeros(())
        if self.parts is None:
            return (sq.sum(), zero) if self.split else (zero, sq.sum())
        split, whole, off = zero, zero, 0
        for w, s in self.parts:
            w = w // self.m if s else w
            part = sq.narrow(-1, off, w).sum()
            if s:
                split = split + part
            else:
                whole = whole + part
            off += w
        return split, whole


def param_cut(cfg: ModelConfig, name, spec: tuple, mesh) -> Cut:
    """The :class:`Cut` of the parameter ``name`` (a module's parameter
    name, or a path in the reference's tree: its last key is read) under
    the rules' ``spec`` on ``mesh``."""
    leaf = name[-1] if isinstance(name, tuple) else name.rsplit(".", 1)[-1]
    if cfg.family != "ssm" or leaf not in SSM_LEAVES:
        return Cut(spec)
    m = axis_sizes(mesh).get(MODEL, 1)
    if not ssm_split(cfg, m):
        return Cut((None,) * len(spec))
    di = cfg.ssm_expand * cfg.d_model
    n, h = cfg.ssm_state, di // cfg.ssm_headdim
    if leaf == "w_in":
        return Cut(spec, ((di, True), (di, True), (n, False), (n, False),
                          (h, True)), m)
    if leaf in ("conv_w", "conv_b"):
        return Cut(spec, ((di, True), (n, False), (n, False)), m)
    return Cut(spec)


def param_cuts(cfg: ModelConfig, mesh) -> dict[str, Cut]:
    """{parameter name of the port's module: its :class:`Cut`}, from
    :func:`param_specs`."""
    return {name: param_cut(cfg, name, spec, mesh)
            for name, spec in param_specs(cfg, mesh).items()}


def batch_axes_for(b: int, mesh, reserve_model: bool = False
                   ) -> tuple[str, ...]:
    """Largest prefix of (pod, data[, model]) whose product divides b
    (``reserve_model``: the MoE keeps the model axis for its experts)."""
    sizes = axis_sizes(mesh)
    axes: list[str] = []
    prod = 1
    tail = () if reserve_model else ("model",)
    for a in _bat(mesh) + tail:
        n = sizes[a]
        if b % (prod * n) == 0:
            axes.append(a)
            prod *= n
        else:
            break
    return tuple(axes)


def batch_spec_tree(cfg: ModelConfig, batch: Any, mesh):
    """Each batch leaf split on its first dimension (``batch_axes_for``)."""
    reserve = cfg.num_experts > 0

    def leaf(path, x):
        axes = batch_axes_for(x.shape[0], mesh, reserve_model=reserve)
        return (axes,) + (None,) * (len(x.shape) - 1)

    return _walk(batch, leaf)


def cache_spec_tree(cfg: ModelConfig, cache: Any, mesh):
    """Decode cache: batch over the data axes; kv-heads over model when
    they divide it, else the cache's sequence dim (layouts of
    ``models.transformer.init_cache``: [stack..., B, S, KV, hd] for k / v,
    [stack..., B, ...] for states, cache_len [B])."""
    ms = axis_sizes(mesh)["model"]

    def leaf(path, x):
        name = str(path[-1])
        shape = x.shape
        if name == "cache_len":
            return (batch_axes_for(shape[0], mesh),)
        if name in ("k", "v", "cross_k", "cross_v") or name.endswith("_k") \
                or name.endswith("_v"):
            lead = len(shape) - 4
            bat = batch_axes_for(shape[lead], mesh)
            if shape[-2] % ms == 0 and "model" not in bat:
                return (None,) * lead + (bat, None, "model", None)
            if shape[-3] % ms == 0 and "model" not in bat:
                return (None,) * lead + (bat, "model", None, None)
            return (None,) * lead + (bat, None, None, None)
        if name == "lru_h" or name.endswith("_h"):
            lead = len(shape) - 2
            bat = batch_axes_for(shape[lead], mesh)
            return (None,) * lead + (bat, "model" if (
                shape[-1] % ms == 0 and "model" not in bat) else None)
        if name == "conv" or name.endswith("_conv"):
            lead = len(shape) - 3
            bat = batch_axes_for(shape[lead], mesh)
            return (None,) * lead + (bat, None, "model" if (
                shape[-1] % ms == 0 and "model" not in bat) else None)
        if name == "h":
            lead = len(shape) - 4
            bat = batch_axes_for(shape[lead], mesh)
            return (None,) * lead + (bat, "model" if (
                shape[-3] % ms == 0 and "model" not in bat) else None,
                None, None)
        return (None,) * len(shape)

    return _walk(cache, leaf)


def bytes_of(tree: Any) -> int:
    """Bytes of every tensor leaf of a tree of nested dicts."""
    total = 0

    def add(_, x):
        nonlocal total
        total += math.prod(x.shape) * x.element_size()

    _walk(tree, add)
    return total


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_leaf(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of the whole leaf ``t`` under ``spec`` on a
    process-group mesh: each split dimension cut into the product of its
    axes' sizes, the piece at this rank's row-major coordinate over them."""
    sizes = axis_sizes(mesh)
    coords = dict(zip(mesh.axis_names, mesh.coords))
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        pos = 0
        for a in axes:
            pos = pos * sizes[a] + coords[a]
        chunk = t.shape[dim] // n
        if chunk * n != t.shape[dim]:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split over {axes} ({n})")
        t = t.narrow(dim, pos * chunk, chunk)
    return t.contiguous()


def gather_leaf(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The inverse of ``shard_leaf``: the whole leaf from every rank's
    slice ``t``, gathered along each split dimension's axes (innermost
    first)."""
    for dim, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            g = mesh.all_gather(t[None], axis=dim, axis_name=a)
            t = g.flatten(dim, dim + 1)
    return t.contiguous()
