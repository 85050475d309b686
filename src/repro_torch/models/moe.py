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

Over a process-group mesh (the reference's GSPMD computes the same
function on any mesh, so both are whole-batch functions):

* ``mp`` (``tensor_parallel.ModelParallel`` whose experts are split): the
  rank holds E / m experts and the replicated router. Every model rank
  routes the same tokens to the same experts; each fills only its own
  experts' rows of the ``[E, C, D]`` buffer, and the float32 (token, slot)
  contributions ``[T, topk, D]``, zero where the expert lives on another
  rank, are summed over the model axis. That sum has one nonzero term a
  pair, so it is exact, and the output equals one process's given the same
  routes.
* ``dp`` (``tensor_parallel.DataRanks``): the rank holds a contiguous block
  of the batch's rows. ``"sort"``'s global group takes its capacity from
  the global token count, and a pair's place in its expert is its place
  among the rank's pairs plus that expert's pairs on the lower data ranks
  (one all-gather of the per-rank counts, :func:`place`). ``"einsum"``'s
  groups are batch rows, so they stay local. The load-balance term uses
  the global ``ce``; each rank returns its share ``E * sum(ce *
  sum_rank(probs) / T)``, so the ranks' terms and gradients sum to the
  reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.tensor_parallel import (copy_to_model,
                                                     reduce_from_model)
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


def place(expert, pos, num_experts: int, capacity_factor: float, dp):
    """``"sort"``'s ranks over the data ranks ``dp``: (pos, the place of
    each of this rank's (token, slot) pairs in its expert over the whole
    batch, its place among the rank's pairs ``pos`` plus the expert's
    pairs on the lower data ranks; keep, pos < capacity; capacity, from the
    global token count as the reference's ``max(1, int(T * topk *
    capacity_factor / E))``)."""
    t, topk = expert.shape
    e = num_experts
    capacity = max(1, int(t * dp.size * topk * capacity_factor / e))
    flat_expert = expert.reshape(-1)
    counts = torch.bincount(flat_expert, minlength=e)
    lower = dp.all_gather(counts)[:dp.index].sum(0)
    pos = pos + lower[flat_expert]
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


def _experts(params, mp):
    """(first expert, experts) this rank holds: all of them unless ``mp``
    splits them."""
    el = params.wg.shape[0]
    return (mp.index * el if mp is not None else 0), el


def _moe_einsum(params, x, probs, gate, expert, e, topk, cf, act, mp=None):
    """The reference's ``_moe_einsum``: dispatch masks [G, S, E, C] one
    slot at a time, the expert FFN on [G, E, C, D], and the gated
    combine. A dispatch product sums one token and zeros, and a combine
    product one gated expert output and zeros, so each is exact. With
    ``mp`` only the rank's experts' columns of the masks are made, and
    each slot's float32 combine (zero for a pair whose expert lives
    elsewhere) is summed over the model axis before the slots are."""
    g, s, d = x.shape
    lo, el = _experts(params, mp)
    rank, keep, cap = group_ranks(expert, g, e, cf)
    x = copy_to_model(x, mp)
    oh = F.one_hot(expert.reshape(g, s, topk), e)[..., lo:lo + el].to(
        x.dtype)                                             # [G,S,K,El]
    gate_g = copy_to_model(gate, mp).reshape(g, s, topk).to(x.dtype)
    xe = torch.zeros((g, el * cap, d), dtype=F32, device=x.device)
    combine = []
    for k in range(topk):
        slot = torch.where(keep[..., k], rank[..., k], cap)
        pos_oh = F.one_hot(slot, cap + 1).to(x.dtype)[..., :cap]  # [G,S,C]
        disp = (oh[..., k, :, None] * pos_oh[..., None, :]).reshape(
            g, s, el * cap)                                  # [G, S, El*C]
        xe = xe + L.bmm_f32(disp.transpose(1, 2), x)
        combine.append(disp * gate_g[..., k, None])
    xe = xe.to(x.dtype).reshape(g, el, cap, d).transpose(0, 1)
    xe = xe.reshape(el, g * cap, d)                          # [El,G*C,D]
    gdt = L.bmm_f32(xe, params.wg)
    udt = L.bmm_f32(xe, params.wu)
    h = (L._act(act, gdt) * udt).to(x.dtype)
    ye = L.bmm_f32(h, params.wd).to(x.dtype)                 # [El, G*C, D]
    ye = ye.reshape(el, g, cap, d).transpose(0, 1).reshape(g, el * cap, d)
    parts = [L.bmm_f32(combine[k], ye) for k in range(topk)]
    if mp is not None:
        parts = list(reduce_from_model(torch.stack(parts), mp))
    yt = torch.zeros((g, s, d), dtype=F32, device=x.device)
    for k in range(topk):
        yt = yt + parts[k]
    return yt.to(x.dtype)


def moe_ffn(params, x, *, num_experts: int, experts_per_token: int,
            capacity_factor: float = 1.25, act: str = "silu",
            impl: str = "sort", mp=None, dp=None):
    """x [B, S, D] -> (y [B, S, D], aux). ``params`` holds wr [D, E] (the
    router, float32), wg / wu [E, D, F] and wd [E, F, D]. ``aux`` is the
    Switch load-balance loss ``E * sum_e f_e * p_e`` (float32). ``impl``
    is the dispatch: "sort" (one global group) or "einsum" (a group per
    batch row). ``mp`` / ``dp``: the model and data ranks (see the
    module's docstring); ``mp`` counts only where it splits the experts."""
    b, s, d = x.shape
    e, topk = num_experts, experts_per_token
    t = b * s
    mp = mp if mp is not None and mp.experts else None
    xt = x.reshape(t, d)
    probs, gate, expert, pos, keep, capacity = route(
        params.wr, xt, e, topk, capacity_factor)
    if dp is None:
        me = torch.mean(probs, dim=0)
        ce = torch.mean(F.one_hot(expert[:, 0], e).to(F32), dim=0)
        aux = e * torch.sum(me * ce)
    else:
        total = t * dp.size
        ce = dp.psum(F.one_hot(expert[:, 0], e).to(F32).sum(0)) / total
        aux = e * torch.sum(ce * (probs.sum(0) / total))
    if impl == "einsum":
        return _moe_einsum(params, x, probs, gate, expert, e, topk,
                           capacity_factor, act, mp), aux
    if impl != "sort":
        raise ValueError(f"moe impl {impl!r}: 'sort' or 'einsum'")
    if dp is not None:
        pos, keep, capacity = place(expert, pos, e, capacity_factor, dp)
    lo, el = _experts(params, mp)
    flat_expert = expert.reshape(-1) - lo
    mine = keep & (flat_expert >= 0) & (flat_expert < el)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(topk)
    dest = torch.where(mine, flat_expert * capacity + pos, el * capacity)

    xt = copy_to_model(xt, mp)
    buf = torch.zeros((el * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xt[flat_tok]
    xe = buf[:el * capacity].reshape(el, capacity, d)
    gdt = L.bmm_f32(xe, params.wg)
    udt = L.bmm_f32(xe, params.wu)
    h = (L._act(act, gdt) * udt).to(x.dtype)
    ye = L.bmm_f32(h, params.wd).reshape(el * capacity, d)       # float32

    contrib = torch.where(
        mine[:, None], ye[torch.clamp(dest, max=el * capacity - 1)]
        * copy_to_model(gate, mp).reshape(-1)[:, None], 0.0
    ).reshape(t, topk, d)
    contrib = reduce_from_model(contrib, mp)
    yt = contrib[:, 0]
    for k in range(1, topk):
        yt = yt + contrib[:, k]
    return yt.reshape(b, s, d).to(x.dtype), aux
