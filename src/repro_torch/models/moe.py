"""Mixture-of-Experts FFN: token-choice top-k routing with capacity (port of
``repro.models.moe``, its ``impl="sort"`` dispatch).

Tokens are ranked within their expert in token order and written into an
``[E, C, D]`` buffer; a (token, slot) pair past the expert's capacity C is
dropped (the residual path carries it), exactly the pairs the reference
drops. The expert FFN is a batched product over the expert axis that
accumulates in float32 on the bf16 stacks (:func:`layers.bmm_f32`).

Every step is deterministic on the card: the top-k is a stable sort (prob
descending, expert ascending, as ``lax.top_k`` breaks ties), the ranks come
from a stable sort and a permutation scatter, the buffer's duplicate writes
all land on the discarded dump row, and each token's ``topk`` weighted
expert outputs are summed one slot at a time in slot order (what the
reference's ``.at[flat_tok].add`` computes; ``index_add_`` would sum
duplicates by atomics, in an order that changes from run to run).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

F32 = torch.float32


def route(router_w, xt, num_experts: int, experts_per_token: int,
          capacity_factor: float):
    """The routing decisions for tokens ``xt [T, D]``: (probs [T, E] float32,
    gate [T, topk] renormalised, expert [T, topk] int64, then
    :func:`ranks`'s pos, keep and capacity)."""
    topk = experts_per_token
    logits = L.dot_f32(xt.to(F32), router_w.to(F32))             # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :topk], expert[:, :topk]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return (probs, gate, expert,
            *ranks(expert, num_experts, capacity_factor))


def ranks(expert, num_experts: int, capacity_factor: float):
    """For the experts [T, topk] picked: (pos [T * topk], the rank of each
    (token, slot) in its expert in token order; keep, pos < capacity;
    capacity, the reference's Python ``max(1, int(T * topk *
    capacity_factor / E))``)."""
    t, topk = expert.shape
    e = num_experts
    capacity = max(1, int(t * topk * capacity_factor / e))
    flat_expert = expert.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    counts = torch.bincount(flat_expert, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = (torch.arange(t * topk, device=expert.device)
                  - starts[flat_expert[order]])
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    return pos, pos < capacity, capacity


def moe_ffn(params, x, *, num_experts: int, experts_per_token: int,
            capacity_factor: float = 1.25, act: str = "silu"):
    """x [B, S, D] -> (y [B, S, D], aux). ``params`` holds wr [D, E] (the
    router, float32), wg / wu [E, D, F] and wd [E, F, D]. ``aux`` is the
    Switch load-balance loss ``E * sum_e f_e * p_e`` (float32)."""
    b, s, d = x.shape
    e, topk = num_experts, experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    probs, gate, expert, pos, keep, capacity = route(
        params.wr, xt, e, topk, capacity_factor)
    flat_expert = expert.reshape(-1)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(topk)
    dest = torch.where(keep, flat_expert * capacity + pos, e * capacity)

    buf = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xt[flat_tok]
    xe = buf[:e * capacity].reshape(e, capacity, d)
    gdt = L.bmm_f32(xe, params.wg)
    udt = L.bmm_f32(xe, params.wu)
    h = (L._act(act, gdt) * udt).to(x.dtype)
    ye = L.bmm_f32(h, params.wd).reshape(e * capacity, d)        # float32

    contrib = torch.where(
        keep[:, None], ye[torch.clamp(dest, max=e * capacity - 1)]
        * gate.reshape(-1)[:, None], 0.0).reshape(t, topk, d)
    yt = contrib[:, 0]
    for k in range(1, topk):
        yt = yt + contrib[:, k]

    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(expert[:, 0], e).to(F32), dim=0)
    aux = e * torch.sum(me * ce)
    return yt.reshape(b, s, d).to(x.dtype), aux
