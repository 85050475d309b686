"""Shared neural layers of the decoder (port of ``repro.models.layers``).

Every function takes tensors and a params module or tensors, as the
reference's take a params pytree. Matmuls accumulate in float32 and round
once, as the reference's ``jnp.dot(..., preferred_element_type=F32)``
(:func:`dot_f32`). Attention is computed with plain torch ops, float32
scores and a float32 softmax, as the reference's is (outside any Pallas
kernel): ``attention`` is :func:`flash_attention`, the chunked prefill and
training attention whose backward recomputes each score block,
``decode_attention`` the single-token one over a KV cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.tensor_parallel import (copy_to_model,
                                                     gather_from_model,
                                                     reduce_from_model,
                                                     sum_over_model)

F32 = torch.float32
NEG_INF = -0.7 * torch.finfo(torch.float32).max


class _ProductF32(torch.autograd.Function):
    """``x @ w`` of two bf16 (or fp16) operands on the card, as cuBLAS's
    ``mm`` / ``bmm(..., out_dtype=float32)``: a float32 accumulator and
    output, which autograd cannot differentiate. The backward takes the
    reference's products: its float32 cotangent against the other operand,
    in float32, rounded once to the operand's dtype. On the tensor cores
    the cotangent is split into a bf16 head and the bf16 rounding of its
    remainder, two products whose float32 sum carries it to within about
    2^-17 of itself (one bf16 rounding would lose 2^-9)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm(x, w, F32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        hi = g.to(x.dtype)
        lo = (g - hi.to(F32)).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = w.mT
            dx = (_mm(hi, wt, F32) + _mm(lo, wt, F32)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            xt = x.mT
            dw = (_mm(xt, hi, F32) + _mm(xt, lo, F32)).to(w.dtype)
        return dx, dw


def _mm(a, b, out_dtype):
    return (torch.mm if a.dim() == 2 else torch.bmm)(a, b, out_dtype=out_dtype)


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` accumulated and returned in float32.

    On the card a bf16 product goes to ``torch.mm(..., out_dtype=float32)``
    (cuBLAS with a float32 accumulator and output; the package turns off
    cuBLAS's reduced-precision bf16 reduction), so the weights stay bf16 in
    memory and nothing is rounded to bf16 before the caller's bias or
    activation; :class:`_ProductF32` differentiates it. On the CPU, where
    that overload is not registered, and for operands of two dtypes, the
    plain version upcasts both."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == F32 and w.dtype == F32:
        out = x2 @ w
    elif x2.is_cuda and x2.dtype == w.dtype:
        out = _ProductF32.apply(x2, w)
    else:
        out = x2.to(F32) @ w.to(F32)
    return out.reshape(*lead, w.shape[-1])


def bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The batched ``x [E, C, K] @ w [E, K, N]``, accumulated and returned
    in float32 (the reference's ``einsum`` over float32 upcasts): on the
    card ``torch.bmm(..., out_dtype=float32)`` on the bf16 operands, so an
    expert stack is read once as bf16 and never written out as float32; on
    the CPU the plain version upcasts, as :func:`dot_f32` does."""
    if x.dtype == F32 and w.dtype == F32:
        return torch.bmm(x, w)
    if x.is_cuda and x.dtype == w.dtype:
        return _ProductF32.apply(x, w)
    return torch.bmm(x.to(F32), w.to(F32))


# ----------------------------------------------------------------- norms ---
def rms_norm(x, scale, eps=1e-6, mp=None):
    """RMS norm in float32; ``scale`` is an offset (the weight is
    ``1 + scale``, initialised to zeros). With ``mp`` (a
    ``tensor_parallel.ModelParallel``) x and ``scale`` hold the rank's
    block of a width split evenly over the model axis: the sum of squares
    is ``sum_over_model``'s, a psum whose gradient is summed too, since
    every rank's channels read it."""
    xf = x.to(F32)
    if mp is None:
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    else:
        ss = torch.sum(torch.square(xf), dim=-1, keepdim=True)
        var = sum_over_model(ss, mp) / (xf.shape[-1] * mp.size)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(F32))).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """Layer norm with a bias, in float32; the variance is the population
    one (``jnp.var``), not torch's default unbiased estimate."""
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


# ------------------------------------------------------------------ rope ---
def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x [..., S, H, hd]; positions [..., S] (int)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # [hd/2]
    ang = positions[..., :, None].to(F32) * freqs             # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ mlps ---
def _act(name: str, x):
    """The reference's activations: ``jax.nn.gelu`` is the tanh
    approximation by default."""
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu(x)
    if name == "relu":
        return F.relu(x)
    raise KeyError(name)


def gated_mlp(params, x, act: str = "silu", mp=None):
    """SwiGLU (act=silu) / GeGLU (act=gelu): (act(x W_g) * x W_u) W_d.

    With ``mp`` (a ``tensor_parallel.ModelParallel`` whose MLP is split)
    the rank holds a column block of W_g / W_u and the row block of W_d:
    its float32 share of the last product is summed over the model axis
    before the one rounding."""
    mp = mp if mp is not None and mp.mlp else None
    x_in = copy_to_model(x, mp)
    g = dot_f32(x_in, params.wg)
    u = dot_f32(x_in, params.wu)
    h = (_act(act, g) * u).to(x.dtype)
    return reduce_from_model(dot_f32(h, params.wd), mp).to(x.dtype)


def dense_mlp(params, x, act: str = "gelu", mp=None):
    """act(x W_1 + b_1) W_2 + b_2; with ``mp`` as :func:`gated_mlp`, the
    replicated b_2 added once, after the sum."""
    mp = mp if mp is not None and mp.mlp else None
    h = dot_f32(copy_to_model(x, mp), params.w1)
    if getattr(params, "b1", None) is not None:
        h = h + params.b1
    h = _act(act, h).to(x.dtype)
    o = reduce_from_model(dot_f32(h, params.w2), mp)
    if getattr(params, "b2", None) is not None:
        o = o + params.b2
    return o.to(x.dtype)


# ------------------------------------------------------- flash attention ---
def _block_mask(q_pos, k_pos, sk_valid: int, causal: bool, window: int):
    """[cq, ck] bool, True = keep: keys past ``sk_valid`` (padding), after
    the query (``causal``) or ``window`` or more behind it are masked."""
    mask = k_pos[None, :] < sk_valid
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


class _Geometry:
    """The static chunking of one flash call: chunk sizes, chunk counts,
    the valid key length and the masks' parameters. ``blocks(qi)`` are the
    kv chunks a q chunk visits: a chunk wholly after the chunk's last query
    (``causal``) or wholly ``window`` or more behind its first is skipped.
    A skipped chunk changes no result: its exp scores are exactly 0 against
    a real row maximum, and what it adds before one (its keys' exp(0) = 1
    terms) is scaled by exp(-inf) = 0 when the row meets its first kept
    key, in the reference's online softmax as here. ``mask(qi, ki)`` is None
    where every key of the block is kept."""

    def __init__(self, causal, window, cq, ck, nq, nk, q_offset, sk_valid):
        self.causal, self.window = causal, window
        self.cq, self.ck, self.nq, self.nk = cq, ck, nq, nk
        self.q_offset, self.sk_valid = q_offset, sk_valid

    def blocks(self, qi: int) -> range:
        q_lo = self.q_offset + qi * self.cq
        q_hi = q_lo + self.cq - 1
        hi = self.nk
        if self.causal:
            hi = min(hi, q_hi // self.ck + 1)
        lo = 0
        if self.window:
            lo = min(max(0, (q_lo - self.window) // self.ck), hi)
        return range(lo, hi)

    def mask(self, qi: int, ki: int, device):
        q_lo = self.q_offset + qi * self.cq
        q_hi = q_lo + self.cq - 1
        k_lo, k_hi = ki * self.ck, (ki + 1) * self.ck - 1
        if (k_hi < self.sk_valid and not (self.causal and k_hi > q_lo)
                and not (self.window and k_lo <= q_hi - self.window)):
            return None
        q_pos = q_lo + torch.arange(self.cq, device=device)
        k_pos = k_lo + torch.arange(self.ck, device=device)
        return _block_mask(q_pos, k_pos, self.sk_valid, self.causal,
                           self.window)


def _scores(qb, kb, mask, scale):
    """Float32 scores [B, KV, G, cq, ck] of q chunk ``qb`` [B, cq, KV, G, hd]
    against k chunk ``kb`` [B, ck, KV, hd], masked to NEG_INF."""
    s = torch.einsum("bqkgh,bckh->bkgqc", qb.to(F32), kb.to(F32)) * scale
    return s if mask is None else torch.where(mask, s, NEG_INF)


def _flash_forward(q, k, v, geo: _Geometry, bdt):
    """The online softmax over kv chunks, one q chunk at a time: float32
    running max ``m``, sum ``l`` and accumulator. q [B, Sq, KV, G, hd],
    k / v [B, Sk, KV, hd], all padded to whole chunks. Returns (out
    [B, Sq, KV, G, hd] in q's dtype, lse [B, KV, G, Sq] float32)."""
    b, _, kvh, g, hd = q.shape
    cq, ck = geo.cq, geo.ck
    scale = 1.0 / float(hd) ** 0.5      # a Python float, as the reference's
    outs, lses = [], []
    for qi in range(geo.nq):
        qb = q[:, qi * cq:(qi + 1) * cq]
        m = torch.full((b, kvh, g, cq), NEG_INF, dtype=F32, device=q.device)
        l = torch.zeros((b, kvh, g, cq), dtype=F32, device=q.device)
        acc = torch.zeros((b, kvh, g, cq, hd), dtype=F32, device=q.device)
        for ki in geo.blocks(qi):
            s = _scores(qb, k[:, ki * ck:(ki + 1) * ck],
                        geo.mask(qi, ki, q.device), scale)
            new_m = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - new_m[..., None])
            corr = torch.exp(m - new_m)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(bdt),
                              v[:, ki * ck:(ki + 1) * ck].to(bdt)).to(F32)
            acc = acc * corr[..., None] + pv
            m = new_m
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)    # [B,Sq,KV,G,hd]
    return out.to(q.dtype), torch.cat(lses, dim=3)


def _flash_backward(q, k, v, out, lse, dout, geo: _Geometry, bdt):
    """dq, dk, dv (float32, then the inputs' dtypes) of the forward above,
    each score block recomputed from q, k and ``lse``: with D = rowsum(dout
    * out), dS = P * (dout v^T - D) * scale (FlashAttention-2's backward,
    the reference's ``flash_bwd``)."""
    b, _, kvh, g, hd = q.shape
    cq, ck = geo.cq, geo.ck
    scale = 1.0 / float(hd) ** 0.5
    do = dout.to(F32)
    dd = torch.sum(do * out.to(F32), dim=-1).permute(0, 2, 3, 1)  # [B,KV,G,Sq]
    dk = torch.zeros(k.shape, dtype=F32, device=k.device)
    dv = torch.zeros(v.shape, dtype=F32, device=v.device)
    dqs = []
    for qi in range(geo.nq):
        rows = slice(qi * cq, (qi + 1) * cq)
        qb = q[:, rows].to(F32)
        dob = do[:, rows]
        lse_b, d_b = lse[..., rows], dd[..., rows]
        dq = torch.zeros((b, cq, kvh, g, hd), dtype=F32, device=q.device)
        for ki in geo.blocks(qi):
            cols = slice(ki * ck, (ki + 1) * ck)
            kb, vb = k[:, cols].to(F32), v[:, cols].to(F32)
            s = _scores(qb, kb, geo.mask(qi, ki, q.device), scale)
            p = torch.exp(s - lse_b[..., None])             # [B,KV,G,cq,ck]
            dv[:, cols] += torch.einsum("bkgqc,bqkgh->bckh", p.to(bdt),
                                        dob.to(bdt)).to(F32)
            dp = torch.einsum("bqkgh,bckh->bkgqc", dob.to(bdt),
                              vb.to(bdt)).to(F32)
            ds = p * (dp - d_b[..., None]) * scale
            dq = dq + torch.einsum("bkgqc,bckh->bqkgh", ds.to(bdt),
                                   kb.to(bdt)).to(F32)
            dk[:, cols] += torch.einsum("bkgqc,bqkgh->bckh", ds.to(bdt),
                                        qb.to(bdt)).to(F32)
        dqs.append(dq)
    return (torch.cat(dqs, dim=1).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """Flash attention with a recompute backward (the reference's
    ``_make_flash_vjp``): the forward saves only (q, k, v, out, lse), never
    a score block, and the backward recomputes each block."""

    @staticmethod
    def forward(ctx, q, k, v, geo, bdt):
        out, lse = _flash_forward(q, k, v, geo, bdt)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.geo, ctx.bdt = geo, bdt
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, dout, ctx.geo,
                                     ctx.bdt)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, q_offset: int = 0, causal: bool = True,
                    window: int = 0, chunk_q: int = 512,
                    chunk_k: int = 1024, block_dtype: str = "float32"):
    """Chunked attention. q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd].

    The reference's ``flash_attention`` on its recompute-VJP path: queries
    in chunks of ``chunk_q``, keys in chunks of ``chunk_k``, both padded to
    whole chunks (padded keys masked), an online softmax over the kv chunks
    in float32, the query at row i at position ``q_offset + i``; ``causal``
    keeps keys at or before it and ``window > 0`` only the last ``window``.
    GQA as the reference's default ``gqa="repeat"``: each kv head is
    repeated over its H // KV query heads, so dk / dv of the repeats are
    summed by the repeat's backward. ``block_dtype``
    is the dtype of the p @ v and backward products (float32 unless the
    caller's ``opts["attn_block_dtype"]`` says otherwise)."""
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
        kvh = h
    g = h // kvh
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    nq, nk = -(-sq // cq), -(-sk // ck)
    if nq * cq != sq:
        q = F.pad(q, (0, 0, 0, 0, 0, nq * cq - sq))
    if nk * ck != sk:
        k = F.pad(k, (0, 0, 0, 0, 0, nk * ck - sk))
        v = F.pad(v, (0, 0, 0, 0, 0, nk * ck - sk))
    geo = _Geometry(causal, int(window), cq, ck, nq, nk, int(q_offset), sk)
    out = _Flash.apply(q.reshape(b, nq * cq, kvh, g, hd), k, v, geo,
                       getattr(torch, block_dtype))
    return out.reshape(b, nq * cq, h, hd)[:, :sq].to(q.dtype)


# the prefill / forward attention of every family
attention = flash_attention


def attention_one_block(q, k, v, q_offset: int = 0, causal: bool = True,
                        window: int = 0):
    """The plain version :func:`flash_attention` is held to: the whole
    float32 score matrix [B, KV, G, Sq, Sk] in one block, differentiated by
    autograd (which keeps it for the backward)."""
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    scale = 1.0 / float(hd) ** 0.5
    qg = q.reshape(b, sq, kvh, g, hd)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    s = _scores(qg, k, _block_mask(q_pos, k_pos, sk, causal, window), scale)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    acc = torch.einsum("bkgqc,bckh->bkgqh", p, v.to(F32))
    out = acc / torch.clamp(torch.sum(p, dim=-1)[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, window: int = 0):
    """Single-token attention over a KV cache.

    q [B,1,H,hd]; k/v_cache [B,Smax,KV,hd]; cache_len [] or [B] — number of
    valid cache entries (the new token's KV must already be written).
    """
    b, _, h, hd = q.shape
    _, smax, kvh, _ = k_cache.shape
    g = h // kvh
    # 1 / sqrt(hd) taken in float32, as the reference's decode scale
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=F32))
    qg = q.reshape(b, kvh, g, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.to(F32), k_cache.to(F32)) * scale
    pos = torch.arange(smax, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device)
    cl = cl[:, None] if cl.ndim == 1 else cl
    mask = pos[None, :] < cl                                  # [B, Smax]
    if window:
        mask = mask & (pos[None, :] >= cl - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(F32))
    return o.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------- projections ---
def qkv_project(params, x, num_heads, num_kv_heads, head_dim, mp=None):
    """x [B,S,D] -> q [B,S,H,hd], k/v [B,S,KV,hd]; the bias is added in
    float32, before the one rounding.

    With ``mp`` (a ``tensor_parallel.ModelParallel`` whose q heads are
    split) q holds the rank's H / m heads, and k / v what
    :func:`kv_project` gives the rank."""
    b, s, _ = x.shape
    heads = mp is not None and mp.heads
    x_in = copy_to_model(x, mp if heads else None)
    q = dot_f32(x_in, params.wq)
    k, v = kv_project(params, x, head_dim, mp, x_in=x_in)
    if getattr(params, "bq", None) is not None:
        q = q + params.bq
    return q.reshape(b, s, -1, head_dim).to(x.dtype), k, v


def kv_project(params, x, head_dim, mp=None, x_in=None, dtype=None):
    """k / v [B,S,KV',hd]: ``x @ W_k`` / ``x @ W_v`` plus their biases
    where ``params`` has them, in float32, rounded once to ``dtype``
    (x's unless given).

    With ``mp`` whose q heads are split, the rank's KV / m kv heads where
    the rules split them: column-parallel products of ``x_in``
    (``copy_to_model(x)`` unless the caller passes the one its q product
    shares, so that their gradient is summed once). Where they do not,
    every kv head, computed whole on every rank, whose gradient (each
    rank holds the share of its own q heads) is summed over the model
    axis before it reaches the replicated W_k / W_v."""
    b, s, _ = x.shape
    dtype = dtype or x.dtype
    heads = mp is not None and mp.heads
    src = x
    if heads and mp.kv:
        src = copy_to_model(x, mp) if x_in is None else x_in
    k = dot_f32(src, params.wk)
    v = dot_f32(src, params.wv)
    if getattr(params, "bk", None) is not None:
        k = k + params.bk
        v = v + params.bv
    if heads and not mp.kv:
        k, v = copy_to_model(k, mp), copy_to_model(v, mp)
    return (k.reshape(b, s, -1, head_dim).to(dtype),
            v.reshape(b, s, -1, head_dim).to(dtype))


def vocab_embed(embed, tokens, mp=None):
    """The rows of the embedding ``embed`` for ``tokens`` (global ids).
    With the vocabulary split over the model axis a rank holds the rows
    of its block: a token outside it looks up zeros, and the ranks'
    lookups are summed, which adds one row to zeros, so it is exact."""
    if mp is None or not mp.vocab:
        return embed[tokens]
    vl = embed.shape[0]
    local = tokens - mp.index * vl
    mine = (local >= 0) & (local < vl)
    x = torch.where(mine[..., None], embed[local.clamp(0, vl - 1)], 0)
    return reduce_from_model(x, mp)


def vocab_logits(x, head, mp=None, vocab_block: bool = False):
    """Float32 logits ``x @ head`` [..., V]. With the vocabulary split
    over the model axis the rank's head is its vocab block: ``vocab_block``
    returns that block [..., V / m], else the blocks are gathered whole."""
    if mp is None or not mp.vocab:
        return dot_f32(x, head)
    y = dot_f32(copy_to_model(x, mp), head)
    return y if vocab_block else gather_from_model(y, mp)


def out_project(params, o, mp=None):
    """o [B,S,H,hd] @ W_o; with ``mp`` whose q heads are split, the rank's
    float32 share of the product (its heads' rows of W_o) summed over the
    model axis before the one rounding."""
    b, s, h, hd = o.shape
    y = dot_f32(o.reshape(b, s, h * hd), params.wo)
    if mp is not None and mp.heads:
        y = reduce_from_model(y, mp)
    return y.to(o.dtype)


def kv_for_heads(k: torch.Tensor, mp) -> torch.Tensor:
    """The kv heads (dim -2 of k [..., KV', hd]) that the rank's q heads
    read, in the grouped-query layout the attention takes: a narrow of
    ``k`` where the local q heads read a run of them in equal groups, else
    one kv head a q head (``index_select``)."""
    if mp is None:
        return k
    block = mp.kv_block()
    if block is not None:
        return k.narrow(-2, *block)
    return k.index_select(-2, torch.tensor(mp.kv_of, device=k.device))
