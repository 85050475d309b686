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

from repro_torch.distributed.tensor_parallel import (copy_to_model,
                                                     reduce_from_model,
                                                     scatter_from_model)
from repro_torch.models import layers as L
from repro_torch.models.ssm import _causal_conv

F32 = torch.float32
_C = 8.0  # Griffin's fixed scalar c


def _lru_coeffs(params, x, mp=None):
    """(a, gated) of the recurrence. With ``mp`` x holds the rank's W / m
    channels and ``w_r`` / ``w_i`` its W / m input rows (the rules'
    split): the rank's product is a float32 partial sum of every output
    channel, and ``scatter_from_model`` sums the ranks' and keeps the
    rank's channels. Its backward all-gathers the channels' gradients, so
    the rank's input rows and x receive the gradient of every output
    channel (a psum followed by a narrow, whose backward is the identity,
    would give each the gradient of its own channels only). The gate
    reads the rank's channels of x, which it holds."""
    xf = x.to(F32)
    r = torch.sigmoid(scatter_from_model(L.dot_f32(xf, params.w_r), mp)
                      + params.b_r)
    i = torch.sigmoid(scatter_from_model(L.dot_f32(xf, params.w_i), mp)
                      + params.b_i)
    log_a = -_C * F.softplus(params.lam) * r              # [B, S, W] (<= 0)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xf)
    return a, gated


def rg_lru(params, x, h0=None, mp=None):
    """x [B, S, W] -> (y [B, S, W] in x's dtype, h_last [B, W] float32);
    with ``mp`` the rank's W / m channels (:func:`_lru_coeffs`)."""
    a, b = _lru_coeffs(params, x, mp)
    h = b[:, 0] if h0 is None else a[:, 0] * h0.to(F32) + b[:, 0]
    ys = [h]
    for t in range(1, x.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    ys = torch.stack(ys, dim=1)
    return ys.to(x.dtype), h


def rg_lru_step(params, x, h, mp=None):
    """Single-token update. x [B, 1, W], h [B, W]."""
    a, b = _lru_coeffs(params, x, mp)
    h_new = a[:, 0] * h.to(F32) + b[:, 0]
    return h_new[:, None].to(x.dtype), h_new


def recurrent_block(params, x, decode_state=None, mp=None):
    """The Griffin recurrent block. x [B, S, D].

    params: w_gate [D, W], w_branch [D, W], conv_w [K, W], conv_b [W],
    lru (w_r, w_i, b_r, b_i, lam), w_out [W, D]. ``decode_state`` is
    ``(conv_buf [B, K, W], h [B, W])`` or None; returns (y, new_state),
    the new state in the same order (the last h without one).

    With ``mp`` (a ``tensor_parallel.ModelParallel`` whose ``lru`` is
    split) the rank runs its W / m channels: ``w_gate`` and ``w_branch``
    are column-parallel after one ``copy_to_model``, the conv, ``b_r``,
    ``b_i`` and ``lam`` per channel, ``w_r`` / ``w_i`` row-parallel
    through a reduce-scatter (:func:`_lru_coeffs`), and ``w_out``
    row-parallel, its float32 partial products summed before the one
    rounding; the decode state is the rank's ([B, K, W / m], [B, W / m])."""
    mp = mp if mp is not None and mp.lru else None
    x_in = copy_to_model(x, mp)
    gate = L._act("gelu", L.dot_f32(x_in, params.w_gate))
    br = L.dot_f32(x_in, params.w_branch).to(x.dtype)
    if decode_state is not None:
        conv_buf, h = decode_state
        conv_buf = torch.cat([conv_buf[:, 1:], br], dim=1)
        c = torch.einsum("bkc,kc->bc", conv_buf.to(F32),
                         params.conv_w.to(F32)) + params.conv_b
        c = c[:, None].to(x.dtype)
        y, h_new = rg_lru_step(params.lru, c, h, mp)
        new_state = (conv_buf, h_new)
    else:
        c = _causal_conv(br, params.conv_w, params.conv_b)
        y, new_state = rg_lru(params.lru, c, mp=mp)
    out = reduce_from_model(
        L.dot_f32((y.to(F32) * gate).to(x.dtype), params.w_out), mp)
    return out.to(x.dtype), new_state
