"""Model API over all ten architectures (port of ``repro.models.model``).

    cfg = get_config("qwen2-1.5b")
    params = model.init_params(cfg, seed)         # or abstract_params(cfg)
    logits, aux = model.forward(cfg, params, batch)
    loss = model.loss_fn(cfg, params, batch)
    cache = model.init_cache(cfg, batch=8, max_seq=1024)
    logits, cache = model.decode_step(cfg, params, cache, token)

``batch`` is a dict with tokens [B, S], labels [B, S] (-1 = masked) for
the loss, and frontend_embeds [B, T, D] for the audio / vision archs
(stubbed embeddings, as the reference's). The ``encdec`` family goes to
``models.encdec``, the decoder families to ``models.transformer``.

:func:`from_host` / :func:`to_host` carry parameters between the packages:
the reference's params pytree as numpy arrays (stacked block leaves; bf16
leaves are numpy arrays whose ``dtype.name`` is ``"bfloat16"``) becomes the
port's module tensor for tensor, bits kept.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tensor_parallel import (ModelParallel,
                                                     model_axis,
                                                     vocab_parallel_nll)
from repro_torch.models import encdec, transformer


def _mod(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else transformer


def init_params(cfg: ModelConfig, rng=0, device=None, mesh=None
                ) -> nn.Module:
    """Seeded parameters on ``device``; on a mesh with a ``model`` axis
    larger than 1, this rank's slices (:func:`shard`) of the one process's
    draws, so that every mesh starts from the same model."""
    return shard(cfg, _mod(cfg).init_params(cfg, rng, device), mesh)


def shard(cfg: ModelConfig, params: nn.Module, mesh) -> nn.Module:
    """``params`` (the whole model) cut to this rank's slices in place:
    every parameter the rules (``distributed.sharding.param_specs``) split
    over ``model`` becomes its slice (its ``sharding.param_cut``), and the
    module keeps the rank's :class:`~repro_torch.distributed.
    tensor_parallel.ModelParallel` as ``params.mp``. A mesh without a
    ``model`` axis larger than 1 leaves the module whole."""
    if model_axis(mesh) == 1:
        return params
    mp = ModelParallel(cfg, mesh)
    for name, p in list(params.named_parameters()):
        cut = mp.cuts[name]
        if cut.split:
            _set(params, name, nn.Parameter(cut.shard(p.detach(), mesh),
                                            requires_grad=p.requires_grad))
    params.mp = mp
    return params


def _set(module: nn.Module, name: str, p: nn.Parameter) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(owner) if owner else module, leaf, p)


def whole(params: nn.Module, named=None):
    """(name, whole tensor) for each of ``named`` ((name, tensor) pairs of
    this rank's slices, by parameter name: ``params.named_parameters()``
    unless given, or the optimizer's moments), the sliced ones gathered
    over the model axis (their ``Cut.gather``; every model rank must call
    it, in the same order)."""
    named = params.named_parameters() if named is None else named
    mp = getattr(params, "mp", None)
    if mp is None:
        yield from named
        return
    for name, t in named:
        cut = mp.cuts[name]
        yield name, cut.gather(t.detach(), mp.mesh) if cut.split else t


def abstract_params(cfg: ModelConfig) -> nn.Module:
    """The parameters' shapes and dtypes, on ``meta``."""
    return _mod(cfg).abstract_params(cfg)


def needs_frontend(cfg: ModelConfig) -> bool:
    return cfg.num_frontend_tokens > 0


def forward(cfg: ModelConfig, params, batch, *, remat: bool = True,
            opts: dict | None = None, mesh=None, vocab_block: bool = False):
    """(logits, aux). On a process-group ``mesh`` the batch is this rank's
    rows; ``vocab_block`` (with the vocabulary split over the model axis)
    keeps the rank's block of the logits (``transformer.forward``,
    ``encdec.forward``)."""
    if cfg.family == "encdec":
        return encdec.forward(cfg, params, batch["tokens"],
                              frontend_embeds=batch["frontend_embeds"],
                              remat=remat, vocab_block=vocab_block)
    return transformer.forward(cfg, params, batch["tokens"],
                               frontend_embeds=batch.get("frontend_embeds"),
                               remat=remat, opts=opts, mesh=mesh,
                               vocab_block=vocab_block)


def loss_fn(cfg: ModelConfig, params, batch, *, remat: bool = True,
            aux_weight: float = 0.01, opts: dict | None = None,
            label_count: torch.Tensor | None = None, mesh=None):
    """Mean next-token cross entropy over the labels >= 0, plus
    ``aux_weight`` times the MoE's load-balance loss: the log-sum-exp of
    the float32 logits less the label's logit. The label's logit is
    gathered, which is exact: it is the value the reference's one-hot sum
    adds to zeros. ``label_count`` replaces the denominator (this batch's
    count of labels >= 0): a data-parallel rank passes the global batch's,
    so the ranks' losses sum to the global batch's mean.

    On a process-group ``mesh`` the batch is this rank's rows and the
    load-balance term the rank's share of the whole batch's
    (``moe.moe_ffn``); with the vocabulary split over the model axis the
    cross entropy is ``tensor_parallel.vocab_parallel_nll`` of the rank's
    vocab block."""
    mp = getattr(params, "mp", None)
    split = mp is not None and mp.vocab
    logits, aux = forward(cfg, params, batch, remat=remat, opts=opts,
                          mesh=mesh, vocab_block=split)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    mask = labels >= 0
    logits = logits.to(torch.float32)
    if split:
        nll = torch.where(mask, vocab_parallel_nll(logits, labels, mp), 0.0)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              labels.clamp(min=0)[..., None])[..., 0]
        nll = torch.where(mask, lse - picked, 0.0)
    count = mask.sum() if label_count is None else label_count
    loss = nll.sum() / count.clamp(min=1)
    return loss + aux_weight * aux


def make_batch(cfg: ModelConfig, batch: int, seq: int, rng=None,
               device=None) -> dict:
    """A random training batch for this arch on ``device`` (``cuda``
    unless given): tokens and labels uniform over the vocabulary, and
    frontend_embeds ``N(0, 0.02^2)`` in ``cfg.dtype`` for the archs that
    attend to them. ``rng`` is a ``torch.Generator`` on that device (a
    fresh one seeded 0 when None)."""
    device = resolve_device(device)
    gen = rng if rng is not None else torch.Generator(device).manual_seed(0)
    out = dict(
        tokens=torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                             device=device, dtype=torch.int32),
        labels=torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                             device=device, dtype=torch.int32))
    if cfg.num_frontend_tokens:
        out["frontend_embeds"] = (torch.randn(
            (batch, cfg.num_frontend_tokens, cfg.d_model), generator=gen,
            device=device) * 0.02).to(getattr(torch, cfg.dtype))
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None,
               mesh=None):
    """The decode cache; on a process-group ``mesh`` this rank's part of a
    cache of ``batch`` global rows (``transformer.init_cache``,
    ``encdec.init_cache``)."""
    return _mod(cfg).init_cache(cfg, batch, max_seq, device, mesh)


def decode_step(cfg: ModelConfig, params, cache, token, mesh=None):
    """One decode step; on a process-group ``mesh`` the token and the cache
    are this rank's rows (``transformer.decode_step``,
    ``encdec.decode_step``)."""
    return _mod(cfg).decode_step(cfg, params, cache, token, mesh)


# ------------------------------------------------------ host carriers ---
def _flatten(tree: dict, prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _tensor(a) -> torch.Tensor:
    """A host array as a tensor with the same bits; bf16 through an int16
    view (neither ml_dtypes nor JAX is needed), uint16 as int16 bits. A
    tensor is taken as it is."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.array(a)           # a writable copy, C order
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16))
    return torch.from_numpy(a)


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as a host array. bf16 comes back as numpy's
    ``bfloat16`` where numpy knows that type (``ml_dtypes`` registers it),
    else as the uint16 bit patterns."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy().view(np.uint16)
    try:
        return bits.view(np.dtype("bfloat16"))
    except TypeError:
        return bits


def _stacked(cfg: ModelConfig) -> dict[str, int]:
    """The reference's stacked subtrees and their number of stacked axes:
    vlm's ``blocks`` [n_super, every, ...] have two, hybrid's ``blocks``
    (``b{i}`` under a superblock axis) and every other stack one."""
    if cfg.family == "encdec":
        return {"enc_blocks": 1, "dec_blocks": 1}
    return {"blocks": 2 if cfg.family == "vlm" else 1, "cross_blocks": 1}


def unstack(cfg: ModelConfig, host_tree: dict, dtype=None) -> dict:
    """{parameter name: tensor} of ``cfg``'s module from a tree in the
    reference's params layout (numpy arrays or tensors): each stacked
    leaf (``blocks`` [L, ...], vlm's [n_super, every, ...],
    ``cross_blocks``, ``enc_blocks``, ``dec_blocks``) split into one
    tensor per index, ``blocks.{i}.<path>`` (``blocks.{s}.{j}.<path>``).
    Every leaf must name a parameter with its shape, and with its dtype
    (``dtype``, when given, for every leaf: the optimizer's moments), and
    every parameter must be given. A bf16 leaf may also come as its uint16
    bits (what :func:`to_host` gives where numpy has no ``bfloat16``)."""
    want = dict(abstract_params(cfg).named_parameters())
    stacked = _stacked(cfg)
    got = {}
    for path, leaf in _flatten(host_tree):
        t = _tensor(leaf)
        axes = stacked.get(path[0], 0)
        for idx in np.ndindex(*t.shape[:axes]):
            got[".".join((path[0], *map(str, idx)) + path[1:])] = t[idx]
    if set(got) != set(want):
        raise ValueError(
            f"leaves do not fit {cfg.name}'s params: missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}")
    for name, t in got.items():
        p = want[name]
        pdt = dtype or p.dtype
        if pdt == torch.bfloat16 and t.dtype == torch.int16:
            t = got[name] = t.view(torch.bfloat16)
        if t.shape != p.shape or t.dtype != pdt:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(p.shape)} {pdt}")
    return got


def from_host(cfg: ModelConfig, host_params: dict, device=None,
              mesh=None) -> nn.Module:
    """The port's parameters on ``device`` (``cuda`` unless given) from the
    reference's params pytree as numpy arrays (or tensors), split by
    :func:`unstack`; on a mesh with a ``model`` axis, this rank's slices
    (:func:`shard`). The parameters have ``requires_grad=False``."""
    device = resolve_device(device)
    module = abstract_params(cfg)
    for name, t in unstack(cfg, host_params).items():
        _set(module, name, nn.Parameter(t.to(device, copy=True).contiguous(),
                                        requires_grad=False))
    return shard(cfg, module, mesh)


def stack(named) -> dict:
    """The inverse of :func:`unstack`: (name, tensor) pairs (a module's
    ``named_parameters()``, or the optimizer's moments by parameter name)
    as the reference's tree of host tensors, each stack's tensors (the
    numeric names after its first key) stacked on leading axes. Every
    tensor is a copy on the CPU (``meta`` tensors stay on ``meta``: a
    tree of shapes and dtypes)."""
    stacks: dict[tuple, dict[tuple, torch.Tensor]] = {}
    for name, p in named:
        path = tuple(name.split("."))
        axes = 0
        while path[1 + axes:] and path[1 + axes].isdigit():
            axes += 1
        key = (path[0],) + path[1 + axes:]
        idx = tuple(int(i) for i in path[1:1 + axes])
        stacks.setdefault(key, {})[idx] = p.detach()
    out: dict = {}
    for path, parts in stacks.items():
        shape = tuple(max(i[a] for i in parts) + 1
                      for a in range(len(next(iter(parts)))))
        if shape:
            arr = torch.stack([parts[i] for i in np.ndindex(*shape)]
                              ).reshape(shape + parts[(0,) * len(shape)].shape)
            arr = arr if arr.is_meta else arr.cpu()
        else:
            arr = parts[()]
            arr = arr if arr.is_meta else arr.to("cpu", copy=True)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return out


def to_host(params: nn.Module) -> dict:
    """The inverse of :func:`from_host`: the reference's params pytree as
    numpy arrays (:func:`stack` of the parameters), whole: a rank's slices
    are gathered over the model axis (:func:`whole`)."""
    return _map(_array, stack(whole(params)))


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}
