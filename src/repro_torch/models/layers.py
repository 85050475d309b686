"""Shared neural layers of the decoder (port of ``repro.models.layers``).

Every function takes tensors and a params module or tensors, as the
reference's take a params pytree. Matmuls accumulate in float32 and round
once, as the reference's ``jnp.dot(..., preferred_element_type=F32)``
(:func:`dot_f32`). Attention is computed with plain torch ops, float32
scores and a float32 softmax, as the reference's is (outside any Pallas
kernel): ``attention`` is the prefill attention ``flash_attention``
computes, ``decode_attention`` the single-token one over a KV cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -0.7 * torch.finfo(torch.float32).max


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` accumulated and returned in float32.

    On the card a bf16 product goes to ``torch.mm(..., out_dtype=float32)``
    (cuBLAS with a float32 accumulator and output; the package turns off
    cuBLAS's reduced-precision bf16 reduction), so the weights stay bf16 in
    memory and nothing is rounded to bf16 before the caller's bias or
    activation. On the CPU, where that overload is not registered, the
    plain version upcasts both operands."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == F32 and w.dtype == F32:
        out = x2 @ w
    elif x2.is_cuda:
        out = torch.mm(x2, w, out_dtype=F32)
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
    if x.is_cuda:
        return torch.bmm(x, w, out_dtype=F32)
    return torch.bmm(x.to(F32), w.to(F32))


# ----------------------------------------------------------------- norms ---
def rms_norm(x, scale, eps=1e-6):
    """RMS norm in float32; ``scale`` is an offset (the weight is
    ``1 + scale``, initialised to zeros)."""
    xf = x.to(F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
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


def gated_mlp(params, x, act: str = "silu"):
    """SwiGLU (act=silu) / GeGLU (act=gelu): (act(x W_g) * x W_u) W_d."""
    g = dot_f32(x, params.wg)
    u = dot_f32(x, params.wu)
    h = (_act(act, g) * u).to(x.dtype)
    return dot_f32(h, params.wd).to(x.dtype)


def dense_mlp(params, x, act: str = "gelu"):
    h = dot_f32(x, params.w1)
    if getattr(params, "b1", None) is not None:
        h = h + params.b1
    h = _act(act, h).to(x.dtype)
    o = dot_f32(h, params.w2)
    if getattr(params, "b2", None) is not None:
        o = o + params.b2
    return o.to(x.dtype)


# ------------------------------------------------------------- attention ---
def attention(q, k, v, q_offset: int = 0, causal: bool = True,
              window: int = 0):
    """Prefill attention: q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd].

    What ``flash_attention`` computes, in one block: GQA by grouping the H
    query heads into KV groups of G = H // KV, the query at row i sits at
    position ``q_offset + i``, ``causal`` keeps keys at or before it and
    ``window > 0`` only the last ``window`` of them. Float32 scores, the
    row maximum subtracted, the unnormalised sum of ``exp`` against v, then
    one division by the row sum, as the reference's online softmax over a
    single chunk. The score matrix is [B, KV, G, Sq, Sk]."""
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    scale = 1.0 / float(hd) ** 0.5      # a Python float, as the reference's
    qg = q.reshape(b, sq, kvh, g, hd)
    s = torch.einsum("bqkgh,bckh->bkgqc", qg.to(F32), k.to(F32)) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.sum(p, dim=-1)
    acc = torch.einsum("bkgqc,bckh->bkgqh", p, v.to(F32))
    out = acc / torch.clamp(denom[..., None], min=1e-30)
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
def qkv_project(params, x, num_heads, num_kv_heads, head_dim):
    """x [B,S,D] -> q [B,S,H,hd], k/v [B,S,KV,hd]; the bias is added in
    float32, before the one rounding."""
    b, s, _ = x.shape
    q = dot_f32(x, params.wq)
    k = dot_f32(x, params.wk)
    v = dot_f32(x, params.wv)
    if getattr(params, "bq", None) is not None:
        q = q + params.bq
        k = k + params.bk
        v = v + params.bv
    return (q.reshape(b, s, num_heads, head_dim).to(x.dtype),
            k.reshape(b, s, num_kv_heads, head_dim).to(x.dtype),
            v.reshape(b, s, num_kv_heads, head_dim).to(x.dtype))


def out_project(params, o):
    b, s, h, hd = o.shape
    return dot_f32(o.reshape(b, s, h * hd), params.wo).to(o.dtype)
