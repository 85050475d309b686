"""Training on the card against the CPU, with no JAX needed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_train.py -q

Without a card every test here skips. The parameters are drawn once on
the CPU and copied to the card, so both devices start from the same
weights and take the same batch.

* The flash Function (forward and dq / dk / dv) on the card against the
  CPU in float32 at Sq = Sk = 1 300 (padded keys), causal with GQA: within
  2e-6 of each output's largest |value|.
* One reduced ``build_train_step`` step, card against CPU, for dense, moe
  (the einsum dispatch, the card's routes replayed on the CPU where a bf16
  flip moves one) and ssm: the loss at rtol 1e-4, each gradient leaf within
  8 bf16 ulps of its largest |entry| (the card's bf16 products accumulate
  in another order than the CPU's float32 upcasts, and a bf16 rounding of
  the residual stream may fall on either side), and the updated
  bf16 parameters equal but for at most 1 % of 1-ulp flips and the
  entries whose gradient lies within that tolerance of zero (the first
  AdamW step is about lr * sign(g) there), the float32 leaves (norm
  offsets, the router, the SSM's) within 1e-4 of their largest |value|
  outside those entries (their first update, lr * m / (sqrt(v) + eps),
  carries the gradients' own gap through the eps term).
* The loop's fault restart at step 12 under
  ``torch.use_deterministic_algorithms(True)``: the losses after the
  restart equal an uninterrupted run's bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import build_train_step
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamW, cosine_schedule

pytestmark = pytest.mark.cuda

LOSS_RTOL, GRAD_ULPS, FLIP_SHARE, FLASH_TOL = 1e-4, 8, 0.01, 2e-6
F32_PARAM_RTOL = 1e-4


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_cuda_flash_matches_cpu(cuda_device):
    gen = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(shape, generator=gen) for shape in (
        (2, 1300, 4, 16), (2, 1300, 2, 16), (2, 1300, 2, 16),
        (2, 1300, 4, 16)))
    outs = {}
    for dev in ("cpu", cuda_device):
        xs = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = L.flash_attention(*xs, causal=True)
        grads = torch.autograd.grad(out, xs, dout.to(dev))
        outs[str(dev)] = [t.detach().cpu() for t in (out, *grads)]
    for got, want in zip(outs[str(cuda_device)], outs["cpu"]):
        gap = float((got - want).abs().max() / want.abs().max())
        assert gap <= FLASH_TOL, gap


class _Recording(AdamW):
    """AdamW that keeps the gradients of its last update."""

    def update(self, grads, state, params):
        object.__setattr__(self, "grads", {n: g.detach().clone()
                                           for n, g in grads.items()})
        return super().update(grads, state, params)


class _Replay:
    """Records the experts each ``moe.route`` call picks, then, replaying,
    makes each call take them (gates renormalised over them)."""

    def __init__(self):
        self.real, self.log, self.replay = MoE.route, [], None

    def route(self, router_w, xt, e, topk, cf):
        probs, gate, expert, *rest = self.real(router_w, xt, e, topk, cf)
        if self.replay is None:
            self.log.append(expert.cpu())
            return (probs, gate, expert, *rest)
        forced = self.replay.pop(0).to(expert.device)
        gate = probs.gather(1, forced)
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
        return (probs, gate, forced, *MoE.ranks(forced, e, cf))


def _step(cfg, params, batch, opts):
    opt = _Recording(lr=cosine_schedule(3e-3, 1, 12))
    step, _ = build_train_step(cfg, None, optimizer=opt, opts=opts)
    params, _, loss = step(params, opt.init(params), batch)
    return float(loss), opt.grads, dict(params.named_parameters())


def _bf16_ulp(top: float) -> float:
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("name, opts", [
    ("qwen2-1.5b", None),
    ("moonshot-v1-16b-a3b", {"moe_impl": "einsum"}),
    ("mamba2-370m", None)])
def test_cuda_train_step_matches_cpu(cuda_device, monkeypatch, name, opts):
    cfg = get_config(name).reduced()
    cpu = M.init_params(cfg, 0, device="cpu")
    card = M.from_host(cfg, M.to_host(cpu), device=cuda_device)
    batch = SyntheticLM(cfg.vocab_size, 16, 4, seed=3).batch_at(0)
    replay = _Replay()
    monkeypatch.setattr(MoE, "route", replay.route)
    got_loss, got_grads, got_params = _step(cfg, card, batch, opts)
    replay.replay = replay.log
    want_loss, want_grads, want_params = _step(cfg, cpu, batch, opts)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    flips = total = 0
    for n, want in want_grads.items():
        want = want.float()
        tol = GRAD_ULPS * _bf16_ulp(float(want.abs().max()))
        gap = float((got_grads[n].cpu().float() - want).abs().max())
        assert gap <= tol, (n, gap, tol)
        got_p = got_params[n].detach().cpu().float()
        want_p = want_params[n].detach().float()
        diff = (got_p - want_p).abs()
        either_sign = want.abs() <= tol
        if want_params[n].dtype == torch.float32:
            assert float(torch.where(either_sign, 0.0, diff).max()) <= (
                F32_PARAM_RTOL * float(want_p.abs().max())), n
            continue
        ulp = torch.from_numpy(np.spacing(want_p.abs().numpy())) * 2.0 ** 16
        assert bool(((diff <= ulp) | either_sign).all()), n
        flips += int(((diff > 0) & ~either_sign).sum())
        total += diff.numel()
    assert flips <= FLIP_SHARE * total


def test_cuda_fault_restart_replays_bit_for_bit(cuda_device, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_config("qwen2-1.5b").reduced()
    crashed = {"done": False}

    def fault(step):
        if step == 12 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    torch.use_deterministic_algorithms(True)
    try:
        rep = train(cfg, None, steps=18, global_batch=8, seq_len=16,
                    ckpt_dir=str(tmp_path / "a"), ckpt_every=5, log_every=0,
                    fault_hook=fault, device=cuda_device)
        clean = train(cfg, None, steps=18, global_batch=8, seq_len=16,
                      ckpt_dir=str(tmp_path / "b"), ckpt_every=5,
                      log_every=0, device=cuda_device)
    finally:
        torch.use_deterministic_algorithms(False)
    assert rep.restarts == 1
    assert rep.losses[:12] == clean.losses[:12]
    assert rep.losses[12:] == clean.losses[10:]
    assert os.path.isdir(tmp_path / "a" / "opt")
