"""Train and serve step builders (port of ``repro.launch.steps``).

``build_train_step(cfg, mesh)``: the full AdamW training step — loss,
gradients, update — as a plain callable on the port's module and optimizer
state. ``build_prefill_step(cfg)``: forward logits only.
``build_serve_step(cfg)``: one-token decode on a cache. Each returns (step
function, the abstract inputs: the parameters on ``meta``), as the
reference's return (jitted function, abstract inputs).

The reference's ``abstract_*_inputs`` and ``input_specs`` are its XLA
dry-run contract (sharded stand-ins to lower and compile) and have no
counterpart. ``mesh`` is None, a mesh of one device, or (the train step) a
``(data, 1)`` process-group mesh: data parallelism, one batch slice per
rank, the parameters and optimizer state replicated. A ``model`` axis
larger than 1 (tensor parallelism) is ROADMAP queue 1 D.2.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import axis_sizes
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamW

#: float32 elements in one all-reduce of the data-parallel gradient sum
GRAD_BUCKET = 1 << 26


def data_parallel_size(mesh) -> int:
    """The mesh's ``data`` size; refuses any other axis larger than 1 (a
    ``model`` axis is tensor parallelism, ROADMAP queue 1 D.2) and a data
    axis larger than 1 that is not a process group."""
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    other = {a: n for a, n in sizes.items() if a != "data" and n != 1}
    if other:
        raise NotImplementedError(
            f"a mesh of axes {sizes}: the port's steps are data parallel; "
            "a model (tensor-parallel) or pod axis is ROADMAP queue 1 D.2")
    data = sizes.get("data", math.prod(sizes.values()))
    if data > 1 and getattr(mesh, "local_size", data) != 1:
        raise NotImplementedError(
            f"a data axis of {data} on one process: data parallelism runs "
            "one rank per batch slice (compat.make_process_mesh)")
    return data


def check_one_device(mesh) -> None:
    """Refuse a mesh of more than one device (the prefill and decode
    steps, which do not shard)."""
    if mesh is None:
        return
    sizes = axis_sizes(mesh)
    if math.prod(sizes.values()) != 1:
        raise NotImplementedError(
            f"a mesh of axes {sizes}: the port's prefill and decode steps "
            "run on one device; sharding them is ROADMAP queue 1 D.2")


def psum_grads(grads: list, mesh, axis: str = "data") -> None:
    """Sum every rank's gradients, in place: each bucket of up to
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
        flat = mesh.psum(flat[None], axis)
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

    On a ``(data, 1)`` process-group mesh of D ranks every rank is given
    the same global batch and takes its rows ``[r B/D, (r + 1) B/D)``.
    The loss is the reference's over the global batch, ``sum(nll) /
    sum(mask)``: each rank divides its rows' ``sum(nll)`` by the mask count
    all-reduced over the ranks, so the ranks' losses and gradients sum to
    the global ones whatever each rank's share of labels. The gradients
    are summed across the ranks in float32 (``psum_grads``) and rounded
    back to the parameters' dtype (bf16) before AdamW, which every rank
    runs on its replica; the returned loss is the global one. The MoE's
    load-balance term is a function of the whole batch's routing, not a
    sum over ranks: with ``data > 1`` the moe family is refused."""
    data = data_parallel_size(mesh)
    if data > 1 and cfg.family == "moe":
        raise NotImplementedError(
            "data parallelism for the moe family: its load-balance loss "
            "needs the router statistics all-reduced across ranks, "
            "ROADMAP queue 1 D.2")
    opt = optimizer or AdamW()

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        named = list(params.named_parameters())
        count = None
        if data > 1:
            rank = mesh.coords[mesh.axis_names.index("data")]
            b = batch["tokens"].shape[0]
            if b % data:
                raise ValueError(f"a global batch of {b} rows does not "
                                 f"split over {data} ranks")
            rows = slice(rank * (b // data), (rank + 1) * (b // data))
            batch = {k: v[rows] for k, v in batch.items()}
            dev = named[0][1].device
            labels = torch.as_tensor(batch["labels"], device=dev)
            count = mesh.psum((labels >= 0).sum()[None], "data")
        loss = M.loss_fn(cfg, params, batch, remat=remat, opts=opts,
                         label_count=count)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        loss = loss.detach()
        if data > 1:
            psum_grads(list(grads), mesh)
            loss = mesh.psum(loss[None], "data")
        opt_state = opt.update({n: g for (n, _), g in zip(named, grads)},
                               opt_state, params)
        return params, opt_state, loss

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
