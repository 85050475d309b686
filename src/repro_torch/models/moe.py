"""Mixture-of-Experts FFN: token-choice top-k routing with capacity (port of
``repro.models.moe``, its ``impl="sort"`` and ``impl="einsum"`` dispatch).

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

``impl="einsum"`` is the reference's GShard dispatch with a group axis (the
batch): each batch row is a group with its own capacity C = S * topk * cf /
E, its (token, slot) pairs ranked in its expert in token order, and
dispatch and combine are one-hot products. It drops other pairs than
``"sort"``'s single global group.
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


def group_ranks(expert, groups: int, num_experts: int,
                capacity_factor: float):
    """``impl="einsum"``'s ranks: the experts [T, topk] picked, as [G, S,
    topk], give (rank, the place of each (token, slot) in its expert within
    its group in token-then-slot order; keep, rank < capacity; capacity,
    ``max(1, int(S * topk * capacity_factor / E))``)."""
    t, topk = expert.shape
    s = t // groups
    e = num_experts
    capacity = max(1, int(s * topk * capacity_factor / e))
    oh = F.one_hot(expert.reshape(groups, s * topk), e)      # [G, S*K, E]
    rank = torch.sum((torch.cumsum(oh, dim=1) - oh) * oh, dim=-1)
    rank = rank.reshape(groups, s, topk)
    return rank, rank < capacity, capacity


def _moe_einsum(params, x, probs, gate, expert, e, topk, cf, act):
    """The reference's ``_moe_einsum``: dispatch masks [G, S, E, C] one
    slot at a time, the expert FFN on [G, E, C, D], and the gated
    combine. A dispatch product sums one token and zeros, and a combine
    product one gated expert output and zeros, so each is exact."""
    g, s, d = x.shape
    rank, keep, cap = group_ranks(expert, g, e, cf)
    oh = F.one_hot(expert.reshape(g, s, topk), e).to(x.dtype)  # [G,S,K,E]
    gate_g = gate.reshape(g, s, topk).to(x.dtype)
    xe = torch.zeros((g, e * cap, d), dtype=F32, device=x.device)
    combine = []
    for k in range(topk):
        slot = torch.where(keep[..., k], rank[..., k], cap)
        pos_oh = F.one_hot(slot, cap + 1).to(x.dtype)[..., :cap]  # [G,S,C]
        disp = (oh[..., k, :, None] * pos_oh[..., None, :]).reshape(
            g, s, e * cap)                                   # [G, S, E*C]
        xe = xe + L.bmm_f32(disp.transpose(1, 2), x)
        combine.append(disp * gate_g[..., k, None])
    xe = xe.to(x.dtype).reshape(g, e, cap, d).transpose(0, 1)  # [E,G,C,D]
    xe = xe.reshape(e, g * cap, d)
    gdt = L.bmm_f32(xe, params.wg)
    udt = L.bmm_f32(xe, params.wu)
    h = (L._act(act, gdt) * udt).to(x.dtype)
    ye = L.bmm_f32(h, params.wd).to(x.dtype)                 # [E, G*C, D]
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    yt = torch.zeros((g, s, d), dtype=F32, device=x.device)
    for k in range(topk):
        yt = yt + L.bmm_f32(combine[k], ye)
    return yt.to(x.dtype)


def moe_ffn(params, x, *, num_experts: int, experts_per_token: int,
            capacity_factor: float = 1.25, act: str = "silu",
            impl: str = "sort"):
    """x [B, S, D] -> (y [B, S, D], aux). ``params`` holds wr [D, E] (the
    router, float32), wg / wu [E, D, F] and wd [E, F, D]. ``aux`` is the
    Switch load-balance loss ``E * sum_e f_e * p_e`` (float32). ``impl``
    is the dispatch: "sort" (one global group) or "einsum" (a group per
    batch row)."""
    b, s, d = x.shape
    e, topk = num_experts, experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    probs, gate, expert, pos, keep, capacity = route(
        params.wr, xt, e, topk, capacity_factor)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(expert[:, 0], e).to(F32), dim=0)
    aux = e * torch.sum(me * ce)
    if impl == "einsum":
        return _moe_einsum(params, x, probs, gate, expert, e, topk,
                           capacity_factor, act), aux
    if impl != "sort":
        raise ValueError(f"moe impl {impl!r}: 'sort' or 'einsum'")
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
    return yt.reshape(b, s, d).to(x.dtype), aux
