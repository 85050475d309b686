"""Similarity spaces from the paper (§IV-A, Eqs. 5-7), in PyTorch.

  sim_L2(u, v)  = 1 - ||u - v||_2                       (Deep1M)
  sim_ip(u, v)  = <u, v>                                 (Txt2img)
  sim_cos(u, v) = <u, v> / (||u|| * ||v||)               (LAION-art)

Port of ``repro.core.similarity`` (``query_sim``, ``pairwise_sim``,
``sim_one``). These are the plain versions; the CUDA kernel in
``kernels/csrc/batch_similarity.cu`` computes the same math on the card.
"""
from __future__ import annotations

import torch

METRICS: tuple[str, ...] = ("l2", "ip", "cos")

_EPS = 1e-12


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on every device.

    The card's float32 ``sqrt`` is the IEEE one; torch's vectorized float32
    ``sqrt`` on the CPU (AVX-512) is off by one ulp for about 0.7 % of
    inputs, so there the float64 root is rounded once to float32, which is
    the IEEE result (and XLA's)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _l2_sim(dots: torch.Tensor, u_sq: torch.Tensor,
            v_sq: torch.Tensor) -> torch.Tensor:
    # sim = 1 - sqrt(||u||^2 - 2<u,v> + ||v||^2); clamp for numerical safety.
    d2 = torch.clamp(u_sq + v_sq - 2.0 * dots, min=0.0)
    return 1.0 - sqrt_rn(d2)


def dot_seq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 dot products over the last axis in one fixed order: a
    fused multiply-add per feature, j = 0 .. d-1, from +0.

    Each step is computed in float64 (the product of two float32 values is
    exact there) and rounded once to float32, which is the float32 fused
    multiply-add. This is the order the CUDA kernels reduce in
    (``kernels/csrc/sim.cuh``), and the order XLA's CPU backend uses for the
    reference's ``jnp.sum(x * q, axis=-1)`` at the test widths, so both
    agree with it bit for bit. Leading axes broadcast.
    """
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    shape = torch.broadcast_shapes(a.shape, b.shape)[:-1]
    acc = torch.zeros(shape, dtype=torch.float32, device=a.device)
    for j in range(a.shape[-1]):
        acc = torch.addcmul(acc.to(torch.float64), a64[..., j],
                            b64[..., j]).to(torch.float32)
    return acc


def query_sim(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """Similarity of query ``q``[..., d] against rows of ``x``[..., d].

    The dot products are a multiply+reduce over the last axis in one fixed
    order (``dot_seq``), never a matmul: each output is reduced over ``d``
    alone, whatever the batch shape around it, so a lane's scores do not
    depend on how many lanes share the call (the batched engine's per-lane
    parity rests on this). Leading axes broadcast, so ``q``[B, 1, d]
    against ``x``[B, M, d] scores B lanes at once.
    """
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    if metric == "ip":
        return dot_seq(x, q)
    if metric not in ("cos", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    # <x, q>, <q, q> and <x, x> in one pass
    xb, qb = torch.broadcast_tensors(x, q)
    dots, qq, xx = dot_seq(torch.stack([xb, qb, xb]), torch.stack([qb, qb, xb]))
    if metric == "cos":
        qn = sqrt_rn(torch.clamp(qq, min=_EPS))
        xn = sqrt_rn(torch.clamp(xx, min=_EPS))
        return dots / (qn * xn)
    return _l2_sim(dots, qq, xx)


def pairwise_sim(x: torch.Tensor, y: torch.Tensor, metric: str) -> torch.Tensor:
    """Pairwise similarity between rows of ``x``[..., m, d] and ``y``[..., n, d]."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    dots = x @ y.transpose(-1, -2)
    if metric == "ip":
        return dots
    if metric == "cos":
        xn = sqrt_rn(torch.clamp(torch.sum(x * x, dim=-1), min=_EPS))
        yn = sqrt_rn(torch.clamp(torch.sum(y * y, dim=-1), min=_EPS))
        return dots / (xn[..., :, None] * yn[..., None, :])
    if metric == "l2":
        return _l2_sim(dots, torch.sum(x * x, dim=-1)[..., :, None],
                       torch.sum(y * y, dim=-1)[..., None, :])
    raise ValueError(f"unknown metric {metric!r}")


def sim_one(u: torch.Tensor, v: torch.Tensor, metric: str) -> torch.Tensor:
    """Scalar similarity between two vectors."""
    return query_sim(u, v[None, :], metric)[0]
