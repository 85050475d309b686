"""Mamba-2 (SSD, state-space duality) block (port of ``repro.models.ssm``;
arXiv:2405.21060).

Chunked SSD: a within-chunk term quadratic in the chunk and a recurrence
over the chunks on the [H, P, N] state; a single-token step for decode.
Everything past the input projection runs in float32, as the reference's
does. Its multi-operand einsums are contracted here two operands at a time
(the same sums, in another float order), so no [.., c, c, H, P] block is
ever formed.

Layout: d_inner = expand * d_model, H = d_inner / headdim heads, state N.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.tensor_parallel import (copy_to_model,
                                                     reduce_from_model)
from repro_torch.models import layers as L

F32 = torch.float32


def _causal_conv(x, w, b):
    """Depthwise causal conv1d. x [B, S, C], w [K, C], b [C]: output t is
    ``sum_k x[t - K + 1 + k] * w[k]`` in float32, then ``+ b``, rounded to
    x's dtype."""
    k = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x.to(F32), (0, 0, k - 1, 0))
    wf = w.to(F32)
    out = xp[:, 0:s] * wf[0]
    for j in range(1, k):
        out = out + xp[:, j:j + s] * wf[j]
    return (out + b).to(x.dtype)


def ssd_chunked(xh, dt, A, B_, C_, chunk: int = 128, h0=None):
    """SSD forward. xh [B, S, H, P], dt [B, S, H], A [H] (negative),
    B_ / C_ [B, S, N]. Returns (y [B, S, H, P] float32, h_last
    [B, H, P, N] float32)."""
    b, s, h, p = xh.shape
    n = B_.shape[-1]
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    xs = xh.reshape(b, nc, c, h, p).to(F32)
    dts = dt.reshape(b, nc, c, h).to(F32)
    Bs = B_.reshape(b, nc, c, n).to(F32)
    Cs = C_.reshape(b, nc, c, n).to(F32)

    dA = dts * A[None, None, None, :]                  # [B, NC, c, H] (<= 0)
    cumA = torch.cumsum(dA, dim=2)
    seg = cumA[:, :, :, None, :] - cumA[:, :, None, :, :]  # [B,NC,q,k,H]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=xh.device))
    # masked before the exp: above the diagonal seg is positive, and where
    # it passes ~88.7 its float32 exp is inf, whose gradient times the
    # mask's zero is NaN (the reference's where(causal, exp(seg), 0) takes
    # that NaN; the forward is the same)
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  -torch.inf))

    # within-chunk: y_diag[q] = sum_k C_q.B_k decay(q, k) dt_k x_k
    cb = torch.einsum("bzqn,bzkn->bzqk", Cs, Bs)
    dx = dts[..., None] * xs                           # [B, NC, c, H, P]
    y_diag = torch.einsum("bzqkh,bzkhp->bzqhp", cb[..., None] * decay, dx)

    # chunk-level state contributions
    chunk_decay = torch.exp(cumA[:, :, -1, :])         # [B, NC, H]
    rem = torch.exp(cumA[:, :, -1:, :] - cumA)         # decay to the end
    state_in = torch.einsum("bzkn,bzkhp->bzhpn", Bs, rem[..., None] * dx)

    hcur = (torch.zeros((b, h, p, n), dtype=F32, device=xh.device)
            if h0 is None else h0.to(F32))
    h_prevs = []
    for z in range(nc):
        h_prevs.append(hcur)
        hcur = hcur * chunk_decay[:, z, :, None, None] + state_in[:, z]
    h_prevs = torch.stack(h_prevs, dim=1)              # [B, NC, H, P, N]

    # across-chunk: y_off[q] = C_q . (decay_to_start(q) * h_prev)
    into = torch.exp(cumA)                             # decay start -> q
    y_off = torch.einsum("bzqn,bzhpn->bzqhp", Cs, h_prevs) * into[..., None]
    y = (y_diag + y_off).reshape(b, nc * c, h, p)[:, :s]
    return y, hcur


def ssd_step(xh, dt, A, B_, C_, h):
    """Single-token SSD update. xh [B, 1, H, P], dt [B, 1, H], B_ / C_
    [B, 1, N], h [B, H, P, N] -> (y [B, 1, H, P] in xh's dtype, h_new
    float32)."""
    dA = torch.exp(dt[:, 0, :, None, None].to(F32) * A[None, :, None, None])
    dx = dt[:, 0, :, None].to(F32) * xh[:, 0].to(F32)          # [B, H, P]
    upd = dx[..., None] * B_[:, 0, None, None, :].to(F32)       # [B,H,P,N]
    h_new = h.to(F32) * dA + upd
    y = torch.einsum("bn,bhpn->bhp", C_[:, 0].to(F32), h_new)
    return y[:, None].to(xh.dtype), h_new


def mamba2_block(params, x, *, headdim: int, d_state: int, chunk: int = 128,
                 decode_state=None, mp=None):
    """The Mamba-2 block. x [B, S, D].

    params: w_in [D, 2*Di + 2*N + H], conv_w [K, Di + 2N], conv_b, A_log
    [H], D_skip [H], norm_scale [Di], w_out [Di, D], dt_bias [H].
    Returns (y, new_state): ``(conv_buf, h)`` with ``decode_state`` (the
    conv buffer shifted by one token), else the last SSD state.

    With ``mp`` (a ``tensor_parallel.ModelParallel`` whose ``ssm`` is
    split) the rank runs its H / m heads: its ``w_in`` holds the heads'
    columns of z, x and dt and every column of B and C, its conv the
    heads' x channels and every B and C channel (``sharding.param_cut``).
    z, x and dt are products of ``copy_to_model(x)`` (each rank holds its
    columns' share of dL/dx); B and C are products of ``x`` itself, the
    same on every rank, so their share of dL/dx is counted once, and
    after the conv and SiLU they pass ``copy_to_model``, which sums their
    gradient over every rank's heads. The conv, the SSD (per head: nothing
    in it sums over heads), ``D_skip`` and ``norm_scale`` run on the rank's
    heads and channels; the gated RMSNorm's sum of squares over the whole
    Di is ``sum_over_model`` (a psum both ways); ``w_out`` is row-parallel,
    its float32 partial products summed before the one rounding. The
    decode state is the rank's: ``conv_buf`` [B, K, Di / m + 2N], ``h``
    [B, H / m, P, N]."""
    b, s, d = x.shape
    di = params.w_out.shape[0]
    h_heads = params.A_log.shape[0]
    n = d_state
    mp = mp if mp is not None and mp.ssm else None

    if mp is None:
        zxbcdt = L.dot_f32(x, params.w_in).to(x.dtype)
        z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n,
                                          zxbcdt.shape[-1] - 2 * di - 2 * n],
                                 dim=-1)
    else:
        w = params.w_in
        x_in = copy_to_model(x, mp)
        zx = L.dot_f32(x_in, w[:, :2 * di]).to(x.dtype)
        bc = L.dot_f32(x, w[:, 2 * di:2 * di + 2 * n]).to(x.dtype)
        dt = L.dot_f32(x_in, w[:, 2 * di + 2 * n:]).to(x.dtype)
        z, xs = torch.split(zx, [di, di], dim=-1)
        xbc = torch.cat([xs, bc], dim=-1)

    if decode_state is not None:
        conv_buf, h0 = decode_state
        conv_buf = torch.cat([conv_buf[:, 1:], xbc], dim=1)
        xbc_conv = torch.einsum("bkc,kc->bc", conv_buf.to(F32),
                                params.conv_w.to(F32))
        xbc_conv = (xbc_conv + params.conv_b)[:, None]
        xbc_conv = F.silu(xbc_conv).to(x.dtype)
    else:
        xbc_conv = F.silu(_causal_conv(xbc, params.conv_w,
                                       params.conv_b)).to(x.dtype)

    xh, B_, C_ = torch.split(xbc_conv, [di, n, n], dim=-1)
    if mp is not None:
        # in float32, as the SSD reads them: the ranks' shares of their
        # gradient are summed before its one rounding
        B_, C_ = copy_to_model(B_.to(F32), mp), copy_to_model(C_.to(F32), mp)
    xh = xh.reshape(b, -1, h_heads, headdim)
    dt = F.softplus(dt.to(F32) + params.dt_bias)
    A = -torch.exp(params.A_log.to(F32))

    if decode_state is not None:
        y, h_new = ssd_step(xh, dt, A, B_, C_, h0)
        new_state = (conv_buf, h_new)
    else:
        y, new_state = ssd_chunked(xh, dt, A, B_, C_, chunk=chunk)
    y = y + xh.to(F32) * params.D_skip[None, None, :, None]
    y = y.reshape(b, -1, di)
    # gated RMSNorm: norm(y * silu(z))
    gated = (y * F.silu(z.to(F32))).to(x.dtype)
    y = L.rms_norm(gated, params.norm_scale, mp=mp)
    out = reduce_from_model(L.dot_f32(y, params.w_out), mp)
    return out.to(x.dtype), new_state
