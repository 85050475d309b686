"""Fault-tolerant training loop (port of ``repro.train.loop``).

One entry, ``train(cfg, ...)``: builds the train step, resumes from the
newest complete checkpoint, prefetches data, checkpoints every N steps
(async; the parameters under ``ckpt_dir`` and the optimizer state under
``ckpt_dir/opt``, in the reference's format), and runs a straggler / fault
monitor:

  * per-step wall times feed an EWMA; a step slower than
    ``straggler_factor`` x EWMA is logged as a straggler event;
  * any exception inside the step triggers restore-from-checkpoint and
    replay (``max_restarts`` bound), exercised by tests via ``fault_hook``
    (injects a crash at a chosen step).

Parameters are made by the port's seeded init (``seed``) on ``device``
(``cuda`` unless given). ``mesh`` is None, a mesh of one device, or a
process-group mesh of axes ``(data, model)`` or ``(pod, data, model)``
(``compat.make_process_mesh``): every rank then draws the same
``SyntheticLM`` global batch and the train step takes its rows; each rank
holds its slices of the one process's seeded parameters over ``model``
(``models.model.init_params(..., mesh)``). Rank 0 writes the checkpoints
and logs, in the reference's format: the parameters and moments are
gathered whole over the model axis first (every model rank joins), and a
restore gives each rank its slices again. Every rank restores (a barrier
after each save completes, so no rank reads a step before it is whole). A
fault must reach every rank at the same step (``fault_hook`` is called on
each), as the collectives of a step are entered by all ranks or none.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.compat import ProcessGroupMesh
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tensor_parallel import model_axis
from repro_torch.launch.steps import build_train_step
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import Prefetcher, SyntheticLM
from repro_torch.train.optimizer import (AdamW, AdamWState,
                                         opt_state_from_host,
                                         opt_state_to_host)


@dataclasses.dataclass
class TrainReport:
    steps_run: int
    final_loss: float
    restarts: int
    straggler_events: list
    losses: list
    step_s: list = dataclasses.field(default_factory=list)


def train(cfg: ModelConfig, mesh=None, *, steps: int, global_batch: int,
          seq_len: int, ckpt_dir: str, ckpt_every: int = 50,
          optimizer: AdamW | None = None, seed: int = 0,
          fault_hook: Callable[[int], None] | None = None,
          straggler_factor: float = 3.0, max_restarts: int = 3,
          log_every: int = 10, device=None) -> TrainReport:
    """Train ``cfg`` for ``steps`` steps; returns the losses of the steps
    run (and, beyond the reference's report, each step's wall in
    ``step_s``: the batch's wait, the step and the loss read back)."""
    device = resolve_device(device)
    opt = optimizer or AdamW(lr=1e-3)
    step_fn, aparams = build_train_step(cfg, mesh, optimizer=opt)
    ranks = mesh.size if isinstance(mesh, ProcessGroupMesh) else 1
    leader = ranks == 1 or mesh.rank == 0
    # the checkpoints' trees: shapes and dtypes, on meta
    like = M.stack(aparams["params"].named_parameters())
    moments = M._map(lambda t: t.to(torch.float32), like)
    opt_like = AdamWState(step=np.zeros((), np.int32), mu=moments,
                          nu=moments)

    def settle():
        """Rank 0's checkpoint writes finished, seen by every rank."""
        saver.wait()
        opt_saver.wait()
        if ranks > 1:
            mesh.barrier()

    def fresh_state():
        params = M.init_params(cfg, seed, device, mesh).requires_grad_(True)
        return params, opt.init(params)

    def restored(last):
        tree = ckpt.restore(ckpt_dir, last, like)
        params = M.from_host(cfg, tree, device, mesh).requires_grad_(True)
        host = ckpt.restore(ckpt_dir + "/opt", last, opt_like)
        return params, opt_state_from_host(cfg, host, device, mesh)

    def save(step):
        """Rank 0 writes the step's checkpoint; where the ranks hold
        slices, every rank first joins the gathers."""
        if not (leader or model_axis(mesh) > 1):
            return
        tree = M.stack(M.whole(params))
        opt_tree = opt_state_to_host(opt_state, params)
        if leader:
            saver.save(step, tree)
            opt_saver.save(step, opt_tree)

    start = 0
    last = ckpt.latest_step(ckpt_dir)
    if last is not None:
        params, opt_state = restored(last)
        start = last
    else:
        params, opt_state = fresh_state()

    saver = ckpt.AsyncCheckpointer(ckpt_dir)
    opt_saver = ckpt.AsyncCheckpointer(ckpt_dir + "/opt")
    data = SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed)
    pf = Prefetcher(data, start_step=start)

    losses: list[float] = []
    step_s: list[float] = []
    stragglers: list[tuple[int, float]] = []
    restarts = 0
    ewma = None
    step = start
    try:
        while step < steps:
            try:
                t0 = time.time()
                dstep, batch = pf.next()
                if fault_hook is not None:
                    fault_hook(dstep)
                fb = dict(batch)
                if M.needs_frontend(cfg):
                    fb["frontend_embeds"] = np.zeros(
                        (batch["tokens"].shape[0], cfg.num_frontend_tokens,
                         cfg.d_model), np.float32)
                params, opt_state, loss = step_fn(params, opt_state, fb)
                loss = float(loss)
                dt = time.time() - t0
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                if dt > straggler_factor * ewma and step > start + 3:
                    stragglers.append((step, dt))
                losses.append(loss)
                step_s.append(dt)
                if leader and log_every and step % log_every == 0:
                    print(f"step {step:6d} loss {loss:.4f} {dt*1e3:.0f}ms",
                          flush=True)
                step += 1
                if ckpt_every and step % ckpt_every == 0:
                    save(step)
            except Exception as e:  # noqa: BLE001 — restart-from-checkpoint
                restarts += 1
                print(f"step {step} failed ({type(e).__name__}: {e}); "
                      f"restart {restarts}/{max_restarts}", flush=True)
                if restarts > max_restarts:
                    raise
                settle()
                del params, opt_state
                last = ckpt.latest_step(ckpt_dir)
                if last is None:
                    params, opt_state = fresh_state()
                    step = 0
                else:
                    params, opt_state = restored(last)
                    step = last
                pf.close()
                pf = Prefetcher(data, start_step=step)
    finally:
        pf.close()
        saver.wait()
        opt_saver.wait()
    if ranks > 1:
        mesh.barrier()
    return TrainReport(steps_run=step - start, final_loss=losses[-1] if losses
                       else float("nan"), restarts=restarts,
                       straggler_events=stragglers, losses=losses,
                       step_s=step_s)
