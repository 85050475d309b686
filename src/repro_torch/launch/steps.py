"""Train and serve step builders (port of ``repro.launch.steps``).

``build_train_step(cfg, mesh)``: the full AdamW training step — loss,
gradients, update — as a plain callable on the port's module and optimizer
state. ``build_prefill_step(cfg, mesh)``: forward logits only.
``build_serve_step(cfg, mesh)``: one-token decode on a cache. Each returns
(step function, the abstract inputs: the parameters on ``meta``), as the
reference's return (jitted function, abstract inputs).

The reference's ``abstract_*_inputs`` and ``input_specs`` are its XLA
dry-run contract (sharded stand-ins to lower and compile) and have no
counterpart. ``mesh`` is None, a mesh of one device, or a process-group
mesh (``compat.make_process_mesh``, ``launch.mesh.make_test_mesh``) of
axes ``(data, model)`` or ``(pod, data, model)``: each rank takes its
block of the global batch's rows over the batch axes (pod and data,
row-major, as the reference's ``_bat``) and holds its slices of the
parameters over ``model`` (``models.model.init_params`` / ``from_host``
with the mesh; the reference's GSPMD places them by
``distributed.sharding.param_spec_tree``, here a rank runs its share of the
layers with ``distributed.tensor_parallel``'s collectives). Every family
runs tensor parallel: the attention heads, MLP width, experts, Mamba-2's
heads and the RG-LRU's width, each where the rules split it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import axis_sizes
from repro_torch.distributed.tensor_parallel import data_ranks
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamW

#: float32 elements in one all-reduce of the data-parallel gradient sum
GRAD_BUCKET = 1 << 26
#: the axes a step's mesh may have
MESH_AXES = ("pod", "data", "model")


def check_mesh(cfg: ModelConfig, mesh) -> None:
    """Refuse a mesh the steps cannot run on: an axis other than ``pod``,
    ``data`` and ``model`` larger than 1, a mesh of more than one device
    that is not a process group (one rank a block)."""
    if mesh is None:
        return
    sizes = axis_sizes(mesh)
    other = {a: n for a, n in sizes.items() if a not in MESH_AXES and n != 1}
    if other:
        raise ValueError(f"a mesh of axes {sizes}: the steps split the batch "
                         f"over pod and data and the layers over model")
    if math.prod(sizes.values()) > 1 and getattr(mesh, "local_size",
                                                 None) != 1:
        raise NotImplementedError(
            f"a mesh of axes {sizes} on one process: the steps run one rank "
            "a block (compat.make_process_mesh)")


def psum_grads(grads: list, dp) -> None:
    """Sum every data rank's gradients (``dp``, a
    ``tensor_parallel.DataRanks``), in place: each bucket of up to
    ``GRAD_BUCKET`` elements is upcast to float32, all-reduced, and
    rounded back to its gradient's dtype."""
    i = 0
    while i < len(grads):
        j, n = i, 0
        while j < len(grads) and (n == 0
                                  or n + grads[j].numel() <= GRAD_BUCKET):
            n += grads[j].numel()
            j += 1
        flat = torch.cat([g.reshape(-1).to(torch.float32)
                          for g in grads[i:j]])
        flat = dp.psum(flat)
        off = 0
        for g in grads[i:j]:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        del flat
        i = j


def build_train_step(cfg: ModelConfig, mesh=None, *,
                     optimizer: AdamW | None = None, remat: bool = True,
                     opts: dict | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: the loss and the gradient of every parameter (turned on for
    ``params`` if off), then the optimizer's update, which writes the new
    parameters and moments in place (the reference donates them).

    On a process-group mesh of D data ranks (pod x data) every rank is
    given the same global batch and takes its block of rows. The loss is
    the reference's over the global batch, ``sum(nll) / sum(mask)``: each
    rank divides its rows' ``sum(nll)`` by the mask count all-reduced over
    the data ranks, so the ranks' losses and gradients sum to the global
    ones whatever each rank's share of labels; the MoE's load-balance term
    is each rank's share of the whole batch's (``models.moe``). The
    gradients are summed over the data ranks only, in float32
    (``psum_grads``), and rounded back to the parameters' dtype (bf16)
    before AdamW, which every rank runs on its slices. A model axis
    needs no sum: the tensor-parallel operators leave a replicated leaf's
    gradient whole on every model rank and a sliced leaf's on its own.
    The returned loss is the global one."""
    check_mesh(cfg, mesh)
    dp = data_ranks(mesh)
    opt = optimizer or AdamW()

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        named = list(params.named_parameters())
        count = None
        if dp is not None:
            rows = dp.rows(batch["tokens"].shape[0])
            batch = {k: v[rows] for k, v in batch.items()}
            dev = named[0][1].device
            labels = torch.as_tensor(batch["labels"], device=dev)
            count = dp.psum((labels >= 0).sum())
        loss = M.loss_fn(cfg, params, batch, remat=remat, opts=opts,
                         label_count=count, mesh=mesh)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        loss = loss.detach()
        if dp is not None:
            psum_grads(list(grads), dp)
            loss = dp.psum(loss)
        opt_state = opt.update({n: g for (n, _), g in zip(named, grads)},
                               opt_state, params)
        return params, opt_state, loss

    aparams = M.abstract_params(cfg)
    return train_step, dict(params=aparams, opt_state=opt.init(aparams))


def build_prefill_step(cfg: ModelConfig, mesh=None, *,
                       opts: dict | None = None):
    """Inference prefill: forward logits only (no gradients). On a
    process-group mesh each data rank runs its rows and the logits come
    back whole (the ranks' rows and vocab blocks gathered)."""
    check_mesh(cfg, mesh)
    dp = data_ranks(mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        if dp is not None:
            rows = dp.rows(batch["tokens"].shape[0])
            batch = {k: v[rows] for k, v in batch.items()}
        logits, _ = M.forward(cfg, params, batch, remat=False, opts=opts,
                              mesh=mesh)
        return logits if dp is None else dp.cat(logits)

    return prefill_step, dict(params=M.abstract_params(cfg))


def build_serve_step(cfg: ModelConfig, mesh=None, *,
                     opts: dict | None = None):
    """One decode step: ``serve_step(params, cache, token) -> (logits,
    cache)``, the cache written in place. ``opts`` is the reference's
    (``decode_cache_in_carry`` only changes its compiled program). On a
    process-group mesh the cache is this rank's
    (``models.model.init_cache(..., mesh=mesh)``), ``token`` the global
    batch's [B, 1], and the logits come back whole."""
    check_mesh(cfg, mesh)
    dp = data_ranks(mesh)
    del opts

    @torch.no_grad()
    def serve_step(params, cache, token):
        if dp is not None:
            token = token[dp.rows(token.shape[0])]
        logits, cache = M.decode_step(cfg, params, cache, token, mesh)
        return (logits if dp is None else dp.cat(logits)), cache

    return serve_step, dict(params=M.abstract_params(cfg))
