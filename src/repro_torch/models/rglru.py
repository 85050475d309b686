"""Griffin / RecurrentGemma recurrent block (port of ``repro.models.rglru``;
arXiv:2402.19427).

Recurrent block = two branches: (linear -> GeLU) gate and
(linear -> causal conv1d(4) -> RG-LRU), merged multiplicatively then
projected out. The RG-LRU recurrence

    r_t = sigmoid(x_t W_r + b_r)
    i_t = sigmoid(x_t W_i + b_i)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

runs over the sequence as a loop over time steps (the reference's
associative scan computes the same values in another float order) and as a
single step for decode, all in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.ssm import _causal_conv

F32 = torch.float32
_C = 8.0  # Griffin's fixed scalar c


def _lru_coeffs(params, x):
    xf = x.to(F32)
    r = torch.sigmoid(L.dot_f32(xf, params.w_r) + params.b_r)
    i = torch.sigmoid(L.dot_f32(xf, params.w_i) + params.b_i)
    log_a = -_C * F.softplus(params.lam) * r              # [B, S, W] (<= 0)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xf)
    return a, gated


def rg_lru(params, x, h0=None):
    """x [B, S, W] -> (y [B, S, W] in x's dtype, h_last [B, W] float32)."""
    a, b = _lru_coeffs(params, x)
    h = b[:, 0] if h0 is None else a[:, 0] * h0.to(F32) + b[:, 0]
    ys = [h]
    for t in range(1, x.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    ys = torch.stack(ys, dim=1)
    return ys.to(x.dtype), h


def rg_lru_step(params, x, h):
    """Single-token update. x [B, 1, W], h [B, W]."""
    a, b = _lru_coeffs(params, x)
    h_new = a[:, 0] * h.to(F32) + b[:, 0]
    return h_new[:, None].to(x.dtype), h_new


def recurrent_block(params, x, decode_state=None):
    """The Griffin recurrent block. x [B, S, D].

    params: w_gate [D, W], w_branch [D, W], conv_w [K, W], conv_b [W],
    lru (w_r, w_i, b_r, b_i, lam), w_out [W, D]. ``decode_state`` is
    ``(conv_buf [B, K, W], h [B, W])`` or None; returns (y, new_state),
    the new state in the same order (the last h without one)."""
    gate = L._act("gelu", L.dot_f32(x, params.w_gate))
    br = L.dot_f32(x, params.w_branch).to(x.dtype)
    if decode_state is not None:
        conv_buf, h = decode_state
        conv_buf = torch.cat([conv_buf[:, 1:], br], dim=1)
        c = torch.einsum("bkc,kc->bc", conv_buf.to(F32),
                         params.conv_w.to(F32)) + params.conv_b
        c = c[:, None].to(x.dtype)
        y, h_new = rg_lru_step(params.lru, c, h)
        new_state = (conv_buf, h_new)
    else:
        c = _causal_conv(br, params.conv_w, params.conv_b)
        y, new_state = rg_lru(params.lru, c)
    out = L.dot_f32((y.to(F32) * gate).to(x.dtype), params.w_out)
    return out.to(x.dtype), new_state
