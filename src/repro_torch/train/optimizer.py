"""AdamW and a cosine schedule (port of ``repro.train.optimizer``).

The state mirrors the parameters: float32 first and second moments ``mu`` /
``nu`` keyed by parameter name, and an int32 ``step`` on the parameters'
device. The update follows the reference's arithmetic: the global-norm clip
summed over every leaf (over a rank's slices and the model axis,
:func:`global_sq_norm`), the moments and the step in float32, weight decay
on every leaf, and the new parameter rounded once to its dtype. It runs
leaf by leaf and in place (the parameters and the moments), so no float32
copy of more than one leaf exists at a time: qwen2-1.5b's embedding alone
is 0.93 GB in float32.

:func:`opt_state_to_host` / :func:`opt_state_from_host` carry a state
across in the reference's layout (``AdamWState(step, mu, nu)`` with ``mu``
/ ``nu`` the params pytree), beside ``models.model.to_host`` /
``from_host``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.tensor_parallel import MODEL, model_axis
from repro_torch.models import model as M

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 []
    mu: dict                    # {parameter name: float32 tensor}
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: nn.Module) -> AdamWState:
        zeros = {name: torch.zeros(p.shape, dtype=F32, device=p.device)
                 for name, p in params.named_parameters()}
        dev = next(params.parameters()).device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=zeros,
                          nu={k: torch.zeros_like(v) for k, v in zeros.items()})

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else torch.tensor(
            self.lr, dtype=F32, device=step.device)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState,
               params: nn.Module) -> AdamWState:
        """One step: ``grads`` {parameter name: gradient}; the parameters
        of ``params`` and the moments of ``state`` are updated in place.
        Returns the new state (its step one more)."""
        step = state.step + 1
        scale = None
        if self.grad_clip > 0:
            gn = torch.sqrt(global_sq_norm(grads, getattr(params, "mp",
                                                          None)))
            scale = torch.clamp(self.grad_clip / (gn + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        stepf = step.to(F32)
        bc1 = 1 - torch.tensor(b1, dtype=F32, device=step.device) ** stepf
        bc2 = 1 - torch.tensor(b2, dtype=F32, device=step.device) ** stepf
        lr = self._lr(step)
        for name, p in params.named_parameters():
            g = grads[name].to(F32)
            if scale is not None:
                g = g * scale
            m, v = state.mu[name], state.nu[name]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            del g
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            pf = p.to(F32)
            u = u + self.weight_decay * pf
            p.copy_((pf - lr * u).to(p.dtype))
        return AdamWState(step=step, mu=state.mu, nu=state.nu)


def global_sq_norm(grads: dict, mp=None) -> torch.Tensor:
    """The squared norm of the whole gradient tree: on a rank that holds
    slices (``mp``, a ``tensor_parallel.ModelParallel``), the sums of
    squares of its split entries summed over the model axis, and those of
    the entries it holds whole counted once (a replicated leaf, and the
    B and C columns of Mamba-2's part-wise ``w_in`` and conv:
    ``sharding.Cut.squares``)."""
    if mp is None:
        return torch.stack([torch.sum(torch.square(g.to(F32)))
                            for g in grads.values()]).sum()
    split, whole = zip(*(mp.cuts[n].squares(g) for n, g in grads.items()))
    split = mp.mesh.psum(torch.stack(split).sum()[None], MODEL)
    return split + torch.stack(whole).sum()


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor * peak`` at ``total``: a function of the int step tensor."""
    def lr(step):
        s = step.to(F32)
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 \
            * (1.0 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)
    return lr


def opt_state_to_host(state: AdamWState, params: nn.Module | None = None
                      ) -> AdamWState:
    """The reference's ``AdamWState`` as numpy: ``step`` int32 [], ``mu`` /
    ``nu`` the params pytree of float32 moments (stacked as
    ``models.model.to_host`` stacks the parameters). A rank's moments are
    slices where its ``params`` are: they are gathered whole over the model
    axis (``models.model.whole``; every model rank calls this)."""
    def tree(moments):
        named = moments.items() if params is None else M.whole(
            params, moments.items())
        return M._map(M._array, M.stack(named))

    return AdamWState(step=state.step.cpu().numpy(), mu=tree(state.mu),
                      nu=tree(state.nu))


def opt_state_from_host(cfg: ModelConfig, host: AdamWState,
                        device=None, mesh=None) -> AdamWState:
    """The port's state on ``device`` (``cuda`` unless given) from the
    reference's ``AdamWState`` (numpy arrays or tensors; a tuple of step,
    mu and nu); on a mesh with a ``model`` axis, this rank's slices of the
    moments (``models.model.from_host``'s)."""
    device = resolve_device(device)
    step, mu, nu = host
    cuts = sh.param_cuts(cfg, mesh) if model_axis(mesh) > 1 else None

    def piece(k, t):
        if cuts is not None and cuts[k].split:
            t = cuts[k].shard(t, mesh)
        return t.to(device, copy=True).contiguous()

    def moments(tree):
        return {k: piece(k, t)
                for k, t in M.unstack(cfg, tree, dtype=F32).items()}

    return AdamWState(
        step=torch.as_tensor(np.asarray(step), dtype=torch.int32,
                             device=device).reshape(()),
        mu=moments(mu), nu=moments(nu))
