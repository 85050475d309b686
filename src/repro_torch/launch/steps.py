"""Train and serve step builders (port of ``repro.launch.steps``).

``build_train_step(cfg)``: the full AdamW training step — loss, gradients,
update — as a plain callable on the port's module and optimizer state.
``build_prefill_step(cfg)``: forward logits only. ``build_serve_step(cfg)``:
one-token decode on a cache. Each returns (step function, the abstract
inputs: the parameters on ``meta``), as the reference's return (jitted
function, abstract inputs).

The reference's ``abstract_*_inputs`` and ``input_specs`` are its XLA
dry-run contract (sharded stand-ins to lower and compile) and have no
counterpart. The steps run on one device: ``mesh`` is None or a mesh of one
device (a process-group mesh is ROADMAP queue 1 D).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamW


def check_one_device(mesh) -> None:
    """Refuse a mesh of more than one device: the port's steps have no
    sharding rules yet (ROADMAP queue 1 D, the process-group mesh)."""
    if mesh is None:
        return
    shape = mesh.shape
    sizes = shape.values() if isinstance(shape, dict) else shape
    if math.prod(int(n) for n in sizes) != 1:
        raise NotImplementedError(
            f"a mesh of shape {tuple(sizes)}: the port trains and serves on "
            "one device; sharding the step over a process-group mesh is "
            "ROADMAP queue 1 D")


def build_train_step(cfg: ModelConfig, mesh=None, *,
                     optimizer: AdamW | None = None, remat: bool = True,
                     opts: dict | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: the loss and the gradient of every parameter (turned on for
    ``params`` if off), then the optimizer's update, which writes the new
    parameters and moments in place (the reference donates them)."""
    check_one_device(mesh)
    opt = optimizer or AdamW()

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        named = list(params.named_parameters())
        loss = M.loss_fn(cfg, params, batch, remat=remat, opts=opts)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        opt_state = opt.update({n: g for (n, _), g in zip(named, grads)},
                               opt_state, params)
        return params, opt_state, loss.detach()

    aparams = M.abstract_params(cfg)
    return train_step, dict(params=aparams, opt_state=opt.init(aparams))


def build_prefill_step(cfg: ModelConfig, mesh=None, *,
                       opts: dict | None = None):
    """Inference prefill: forward logits only (no gradients)."""
    check_one_device(mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = M.forward(cfg, params, batch, remat=False, opts=opts)
        return logits

    return prefill_step, dict(params=M.abstract_params(cfg))


def build_serve_step(cfg: ModelConfig, mesh=None, *,
                     opts: dict | None = None):
    """One decode step: ``serve_step(params, cache, token) -> (logits,
    cache)``, the cache written in place. ``opts`` is the reference's
    (``decode_cache_in_carry`` only changes its compiled program)."""
    check_one_device(mesh)
    del opts

    @torch.no_grad()
    def serve_step(params, cache, token):
        return M.decode_step(cfg, params, cache, token)

    return serve_step, dict(params=M.abstract_params(cfg))
