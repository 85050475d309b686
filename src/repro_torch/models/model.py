"""Model API over the ported architectures (port of ``repro.models.model``).

    cfg = get_config("qwen2-1.5b")
    params = model.init_params(cfg, seed)         # or abstract_params(cfg)
    logits, aux = model.forward(cfg, params, batch)
    cache = model.init_cache(cfg, batch=8, max_seq=1024)
    logits, cache = model.decode_step(cfg, params, cache, token)

``batch`` is a dict with tokens [B, S]. The decoder families go to
``models.transformer`` (the dense family is ported); ``encdec`` raises
``NotImplementedError`` (ROADMAP queue 1 G), as do ``loss_fn`` and
``make_batch``, which wait for the training slice.

:func:`from_host` / :func:`to_host` carry parameters between the packages:
the reference's params pytree as numpy arrays (stacked ``[L, ...]`` block
leaves; bf16 leaves are numpy arrays whose ``dtype.name`` is
``"bfloat16"``) becomes the port's module tensor for tensor, bits kept.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def _mod(cfg: ModelConfig):
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"the 'encdec' family ({cfg.name}) is not ported yet: ROADMAP "
            "queue 1 G; this slice ports the dense decoder")
    return transformer


def init_params(cfg: ModelConfig, rng=0, device=None) -> nn.Module:
    return _mod(cfg).init_params(cfg, rng, device)


def abstract_params(cfg: ModelConfig) -> nn.Module:
    """The parameters' shapes and dtypes, on ``meta``."""
    return _mod(cfg).abstract_params(cfg)


def needs_frontend(cfg: ModelConfig) -> bool:
    return cfg.num_frontend_tokens > 0


def forward(cfg: ModelConfig, params, batch):
    return _mod(cfg).forward(cfg, params, batch["tokens"])


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    return _mod(cfg).init_cache(cfg, batch, max_seq, device)


def decode_step(cfg: ModelConfig, params, cache, token):
    return _mod(cfg).decode_step(cfg, params, cache, token)


# ------------------------------------------------------ host carriers ---
def _flatten(tree: dict, prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A host array as a tensor with the same bits; bf16 through an int16
    view (neither ml_dtypes nor JAX is needed), uint16 as int16 bits."""
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


def from_host(cfg: ModelConfig, host_params: dict, device=None) -> nn.Module:
    """The port's parameters on ``device`` (``cuda`` unless given) from the
    reference's params pytree as numpy arrays: each stacked ``blocks`` leaf
    ``[L, ...]`` becomes layer i's parameter ``blocks.{i}.<path>``. Every
    leaf must name a parameter of ``cfg``'s module with its shape and
    dtype, and every parameter must be given. A bf16 parameter may also
    come as its uint16 bits (what :func:`to_host` gives where numpy has no
    ``bfloat16``)."""
    device = resolve_device(device)
    module = abstract_params(cfg)
    want = dict(module.named_parameters())
    got = {}
    for path, leaf in _flatten(host_params):
        t = _tensor(leaf)
        if path[0] == "blocks":
            for i in range(t.shape[0]):
                got[".".join(("blocks", str(i)) + path[1:])] = t[i]
        else:
            got[".".join(path)] = t
    if set(got) != set(want):
        raise ValueError(
            f"params do not fit {cfg.name}: missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}")
    for name, t in got.items():
        p = want[name]
        if p.dtype == torch.bfloat16 and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(p.shape)} {p.dtype}")
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf, nn.Parameter(
            t.to(device).contiguous(), requires_grad=False))
    return module


def to_host(params: nn.Module) -> dict:
    """The inverse of :func:`from_host`: the reference's params pytree, the
    layers' parameters stacked on a leading axis."""
    out: dict = {}
    layers: dict[tuple, list] = {}
    for name, p in params.named_parameters():
        path = tuple(name.split("."))
        if path[0] == "blocks":
            layers.setdefault(("blocks",) + path[2:], []).append(_array(p))
            continue
        out[path[0]] = _array(p)
    for path, arrs in layers.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arrs)
    return out
