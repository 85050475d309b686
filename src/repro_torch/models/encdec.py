"""Encoder-decoder family, whisper-small's backbone (port of
``repro.models.encdec``).

The audio conv frontend is a stub, as in the reference: precomputed frame
embeddings [B, T, D] go straight into the encoder stack. Whisper's
conventions: layer norms with a bias, a plain GELU MLP, sinusoidal
positions on the encoder, learned positions on the decoder (``dec_pos``
[4096, D], tiled past 4096 in ``forward``), full multi-head attention with
q / k / v biases, and cross-attention from every decoder layer into the
encoder's output. The parameters are an ``nn.Module``
(:class:`EncDecLM`) named as the reference's pytree, with the layer index
after ``enc_blocks`` / ``dec_blocks``.

``decode_step`` reads the cross-attention's k / v from the cache
(``cross_k`` / ``cross_v`` [L, B, T, KV, hd]); ``init_cache`` makes them
zeros, and the RAG pipeline never fills them, as the reference's does not.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (DenseMLP, _Init, make_init,
                                            torch_dtype)

F32 = torch.float32
POSITIONS = 4096          # the learned decoder positions


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """[length, channels] float32: sin then cos of ``t * 10000^(-i / (C/2 -
    1))``, the reference's float32 arithmetic."""
    t = torch.arange(length, dtype=F32, device=device)[:, None]
    half = channels // 2
    inv = torch.exp(-torch.log(torch.tensor(10000.0, device=device))
                    * torch.arange(half, dtype=F32, device=device)
                    / (half - 1))
    ang = t * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class LayerNorm(nn.Module):
    def __init__(self, d: int, init: _Init):
        super().__init__()
        self.scale = init.full((d,), 1.0, F32)
        self.bias = init.zeros((d,), F32)


class MHA(nn.Module):
    """Attention with q / k / v biases (always, in this family)."""

    def __init__(self, cfg: ModelConfig, init: _Init, dt):
        super().__init__()
        d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim)
        sc = d ** -0.5
        self.wq = init.normal((d, h * hd), sc, dt)
        self.wk = init.normal((d, kv * hd), sc, dt)
        self.wv = init.normal((d, kv * hd), sc, dt)
        self.wo = init.normal((h * hd, d), (h * hd) ** -0.5, dt)
        self.bq = init.zeros((h * hd,), dt)
        self.bk = init.zeros((kv * hd,), dt)
        self.bv = init.zeros((kv * hd,), dt)


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, init: _Init, dt):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, init)
        self.attn = MHA(cfg, init, dt)
        self.ln2 = LayerNorm(cfg.d_model, init)
        self.mlp = DenseMLP(cfg, init, dt)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, init: _Init, dt):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, init)
        self.self_attn = MHA(cfg, init, dt)
        self.ln2 = LayerNorm(cfg.d_model, init)
        self.cross_attn = MHA(cfg, init, dt)
        self.ln3 = LayerNorm(cfg.d_model, init)
        self.mlp = DenseMLP(cfg, init, dt)


class EncDecLM(nn.Module):
    """whisper's parameters (the reference's params pytree)."""

    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        dt = torch_dtype(cfg)
        self.embed = init.normal((cfg.vocab_size, cfg.d_model), 0.02, dt)
        self.dec_pos = init.normal((POSITIONS, cfg.d_model), 0.01, dt)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, init, dt)
                                        for _ in range(cfg.encoder_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, init, dt)
                                        for _ in range(cfg.num_layers))
        self.enc_ln = LayerNorm(cfg.d_model, init)
        self.dec_ln = LayerNorm(cfg.d_model, init)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ModelConfig, rng=0, device=None) -> EncDecLM:
    """Seeded random parameters on ``device`` (``cuda`` unless given); see
    ``transformer.init_params``."""
    return EncDecLM(cfg, make_init(rng, device))


def abstract_params(cfg: ModelConfig) -> EncDecLM:
    return init_params(cfg, device="meta")


def _ln(p: LayerNorm, x):
    return L.layer_norm(x, p.scale, p.bias)


def _project(w, b, x, heads: int, hd: int):
    """``(x @ w + b)`` in float32, split into heads, rounded once."""
    out = L.dot_f32(x, w) + b
    return out.reshape(x.shape[0], x.shape[1], heads, hd).to(x.dtype)


def _mha(attn: MHA, q_src, kv_src, cfg: ModelConfig, causal: bool,
         decode=None):
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = _project(attn.wq, attn.bq, q_src, h, hd)
    k = _project(attn.wk, attn.bk, kv_src, kv, hd)
    v = _project(attn.wv, attn.bv, kv_src, kv, hd)
    if decode is not None:
        k_cache, v_cache, cache_len = decode
        # written at cache_len, in place; a write past the cache's end is
        # dropped, as the reference's scatter drops it
        smax = k_cache.shape[1]
        idx = torch.clamp(cache_len, max=smax - 1).long()
        inside = (cache_len < smax)[:, None, None]
        bidx = torch.arange(k.shape[0], device=k.device)
        k_cache[bidx, idx] = torch.where(inside, k[:, 0], k_cache[bidx, idx])
        v_cache[bidx, idx] = torch.where(inside, v[:, 0], v_cache[bidx, idx])
        o = L.decode_attention(q, k_cache, v_cache, cache_len + 1)
        return L.out_project(attn, o)
    o = L.attention(q, k, v, causal=causal)
    return L.out_project(attn, o)


def encode(cfg: ModelConfig, params: EncDecLM, frames):
    """frames [B, T, D] (the stubbed frontend's output) -> [B, T, D]."""
    dt = torch_dtype(cfg)
    frames = torch.as_tensor(frames, device=params.device)
    x = frames.to(dt) + sinusoids(frames.shape[1], cfg.d_model,
                                  params.device).to(dt)[None]
    for p in params.enc_blocks:
        h = _ln(p.ln1, x)
        x = x + _mha(p.attn, h, h, cfg, causal=False)
        h = _ln(p.ln2, x)
        x = x + L.dense_mlp(p.mlp, h, "gelu")
    return _ln(params.enc_ln, x)


def _logits(params: EncDecLM, x):
    x = _ln(params.dec_ln, x)
    return L.dot_f32(x, params.embed.t())


def forward(cfg: ModelConfig, params: EncDecLM, tokens, *, frontend_embeds):
    """Teacher-forced decoder logits. tokens [B, S]; frontend [B, T, D] ->
    (logits [B, S, V] float32, 0.0)."""
    enc = encode(cfg, params, frontend_embeds)
    tokens = torch.as_tensor(tokens, device=params.device).long()
    s = tokens.shape[1]
    pos = params.dec_pos
    if s > pos.shape[0]:      # learned positions tiled past their length
        pos = pos.repeat(math.ceil(s / pos.shape[0]), 1)
    x = params.embed[tokens].to(torch_dtype(cfg)) + pos[:s][None]
    for p in params.dec_blocks:
        h = _ln(p.ln1, x)
        x = x + _mha(p.self_attn, h, h, cfg, causal=True)
        h = _ln(p.ln2, x)
        x = x + _mha(p.cross_attn, h, enc, cfg, causal=False)
        h = _ln(p.ln3, x)
        x = x + L.dense_mlp(p.mlp, h, "gelu")
    return _logits(params, x), 0.0


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> dict:
    """``cache_len`` int32[B]; self-attention ``k`` / ``v`` [L, B, max_seq,
    KV, hd] and cross-attention ``cross_k`` / ``cross_v`` [L, B, T, KV, hd]
    (T = ``cfg.num_frontend_tokens``), zeros in ``cfg.dtype``."""
    device = resolve_device(device)
    dt = torch_dtype(cfg)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    t = cfg.num_frontend_tokens
    nl = cfg.num_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    return dict(cache_len=torch.zeros((batch,), dtype=torch.int32,
                                      device=device),
                k=zeros(nl, batch, max_seq, kv, hd),
                v=zeros(nl, batch, max_seq, kv, hd),
                cross_k=zeros(nl, batch, t, kv, hd),
                cross_v=zeros(nl, batch, t, kv, hd))


def decode_step(cfg: ModelConfig, params: EncDecLM, cache: dict, token):
    """One decoder step against the cache's cross k / v. token [B, 1] ->
    (logits [B, 1, V], cache); the self-attention k / v are written into
    the cache in place."""
    dt = torch_dtype(cfg)
    token = torch.as_tensor(token, device=params.device).long()
    b = token.shape[0]
    cache_len = cache["cache_len"]
    pidx = torch.remainder(cache_len, params.dec_pos.shape[0]).long()
    x = params.embed[token].to(dt) + params.dec_pos[pidx][:, None]
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    t = cache["cross_k"].shape[2]
    for i, p in enumerate(params.dec_blocks):
        h = _ln(p.ln1, x)
        x = x + _mha(p.self_attn, h, h, cfg, causal=True,
                     decode=(cache["k"][i], cache["v"][i], cache_len))
        h = _ln(p.ln2, x)
        q = _project(p.cross_attn.wq, p.cross_attn.bq, h, hq, hd)
        o = L.decode_attention(q, cache["cross_k"][i], cache["cross_v"][i],
                               torch.full((b,), t, dtype=torch.int32,
                                          device=x.device))
        x = x + L.out_project(p.cross_attn, o)
        h = _ln(p.ln3, x)
        x = x + L.dense_mlp(p.mlp, h, "gelu")
    return _logits(params, x), dict(cache, cache_len=cache_len + 1)
