"""Decoder-only model assembly, dense family (port of
``repro.models.transformer``).

The parameters are an ``nn.Module`` (:class:`DecoderLM`) whose names are
the reference's pytree paths with the layer index after ``blocks``: the
reference's stacked ``blocks/attn/wq [L, D, H*hd]`` is the port's
``blocks.{i}.attn.wq [D, H*hd]``, one ``Block`` per layer in a
``ModuleList`` (a Python loop over the layers takes the place of
``lax.scan``). Weights keep the reference's ``x @ W`` layout and dtypes:
the matrices and the embedding in ``cfg.dtype``, the norm offsets in
float32. Parameters are made with ``requires_grad=False``: this slice
serves; training is a later one.

The families ``moe``, ``vlm``, ``hybrid`` and ``ssm`` raise
``NotImplementedError`` (ROADMAP queue 1 G). The reference's XLA knobs
(``remat``, ``skip_future``, ``opts``, ``decode_cache_in_carry``) have no
counterpart: they change the compiled program, not the result.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

F32 = torch.float32
PORTED_FAMILIES = ("dense",)


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet: "
            "ROADMAP queue 1 G; this slice ports the dense decoder")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# =================================================================== init ===
class _Init:
    """Seeded draws on one device; on ``meta`` shapes and dtypes only."""

    def __init__(self, generator: torch.Generator | None,
                 device: torch.device):
        self.generator = generator
        self.device = device

    def normal(self, shape, std: float, dtype) -> nn.Parameter:
        if self.device.type == "meta":
            t = torch.empty(shape, dtype=dtype, device=self.device)
        else:
            t = (torch.randn(shape, generator=self.generator, dtype=F32,
                             device=self.device) * std).to(dtype)
        return nn.Parameter(t, requires_grad=False)

    def zeros(self, shape, dtype) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                        device=self.device),
                            requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, init: _Init, dt):
        super().__init__()
        d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim)
        sc = d ** -0.5
        self.wq = init.normal((d, h * hd), sc, dt)
        self.wk = init.normal((d, kv * hd), sc, dt)
        self.wv = init.normal((d, kv * hd), sc, dt)
        self.wo = init.normal((h * hd, d), (h * hd) ** -0.5, dt)
        if cfg.qkv_bias:
            self.bq = init.zeros((h * hd,), dt)
            self.bk = init.zeros((kv * hd,), dt)
            self.bv = init.zeros((kv * hd,), dt)


class GatedMLP(nn.Module):
    def __init__(self, cfg: ModelConfig, init: _Init, dt):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wg = init.normal((d, f), d ** -0.5, dt)
        self.wu = init.normal((d, f), d ** -0.5, dt)
        self.wd = init.normal((f, d), f ** -0.5, dt)


class DenseMLP(nn.Module):
    """The plain two-matrix MLP (``mlp_act="gelu_mlp"``)."""

    def __init__(self, cfg: ModelConfig, init: _Init, dt):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w1 = init.normal((d, f), d ** -0.5, dt)
        self.b1 = init.zeros((f,), dt)
        self.w2 = init.normal((f, d), f ** -0.5, dt)
        self.b2 = init.zeros((d,), dt)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, init: _Init, dt):
        super().__init__()
        self.norm1 = init.zeros((cfg.d_model,), F32)
        self.attn = Attention(cfg, init, dt)
        self.norm2 = init.zeros((cfg.d_model,), F32)
        self.mlp = (DenseMLP if cfg.mlp_act == "gelu_mlp" else GatedMLP)(
            cfg, init, dt)


class DecoderLM(nn.Module):
    """The dense decoder's parameters (the reference's params pytree)."""

    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        dt = torch_dtype(cfg)
        self.embed = init.normal((cfg.vocab_size, cfg.d_model), 0.02, dt)
        self.final_norm = init.zeros((cfg.d_model,), F32)
        if not cfg.tie_embeddings:
            self.lm_head = init.normal((cfg.d_model, cfg.vocab_size),
                                       cfg.d_model ** -0.5, dt)
        self.blocks = nn.ModuleList(Block(cfg, init, dt)
                                    for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        """The output projection [D, V]: ``lm_head``, or the tied
        embedding's transpose (a view)."""
        head = getattr(self, "lm_head", None)
        return self.embed.t() if head is None else head


def init_params(cfg: ModelConfig, rng=0, device=None) -> DecoderLM:
    """Seeded random parameters on ``device`` (``cuda`` unless given).

    ``rng`` is a seed or a ``torch.Generator`` on that device. The draws
    are the reference's distributions (normal, scaled by fan-in; zero
    biases and norm offsets), not its values. ``device="meta"`` gives
    shapes and dtypes only, with no draws."""
    check_family(cfg)
    device = resolve_device(device)
    if isinstance(rng, torch.Generator) or device.type == "meta":
        gen = rng if isinstance(rng, torch.Generator) else None
    else:
        gen = torch.Generator(device=device).manual_seed(int(rng))
    return DecoderLM(cfg, _Init(gen, device))


def abstract_params(cfg: ModelConfig) -> DecoderLM:
    return init_params(cfg, device="meta")


# ================================================================ forward ===
def _embed(cfg: ModelConfig, params: DecoderLM, tokens) -> torch.Tensor:
    """Token embeddings in ``cfg.dtype``; tied ones times sqrt(d_model)
    rounded to that dtype first, as the reference's
    ``x * jnp.asarray(d_model ** 0.5, dt)`` (39.25 for 1 536 in bf16)."""
    dt = torch_dtype(cfg)
    tokens = torch.as_tensor(tokens, device=params.device).long()
    x = params.embed[tokens].to(dt)
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x


def _self_attn(blk: Block, x, positions, cfg: ModelConfig, decode=None):
    h = L.rms_norm(x, blk.norm1, cfg.norm_eps)
    q, k, v = L.qkv_project(blk.attn, h, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if decode is not None:
        k_cache, v_cache, cache_len = decode
        # write the current kv at cache_len mod max_seq, in place
        idx = torch.remainder(cache_len, k_cache.shape[1]).long()
        bidx = torch.arange(k.shape[0], device=k.device)
        k_cache[bidx, idx] = k[:, 0]
        v_cache[bidx, idx] = v[:, 0]
        o = L.decode_attention(q, k_cache, v_cache, cache_len + 1)
        return x + L.out_project(blk.attn, o)
    o = L.attention(q, k, v, q_offset=0, causal=True)
    return x + L.out_project(blk.attn, o)


def _ffn(blk: Block, x, cfg: ModelConfig):
    h = L.rms_norm(x, blk.norm2, cfg.norm_eps)
    if cfg.mlp_act == "gelu_mlp":
        return x + L.dense_mlp(blk.mlp, h, "gelu")
    return x + L.gated_mlp(blk.mlp, h, cfg.mlp_act)


def _logits(cfg: ModelConfig, params: DecoderLM, x) -> torch.Tensor:
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return L.dot_f32(x, params.head())


def forward(cfg: ModelConfig, params: DecoderLM, tokens):
    """Token logits for prefill. tokens [B, S] -> logits [B, S, V] float32.

    Returns (logits, aux_loss); the dense family's aux loss is 0."""
    check_family(cfg)
    x = _embed(cfg, params, tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for blk in params.blocks:
        x = _self_attn(blk, x, positions, cfg)
        x = _ffn(blk, x, cfg)
    return _logits(cfg, params, x), 0.0


# ================================================================= decode ===
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> dict:
    """Decode cache: ``cache_len`` int32[B] and the stacked
    ``k`` / ``v`` [L, B, max_seq, KV, hd] in ``cfg.dtype`` on ``device``
    (``cuda`` unless given)."""
    check_family(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return dict(cache_len=torch.zeros((batch,), dtype=torch.int32,
                                      device=device),
                k=torch.zeros(shape, dtype=dt, device=device),
                v=torch.zeros(shape, dtype=dt, device=device))


def decode_step(cfg: ModelConfig, params: DecoderLM, cache: dict, token):
    """One decode step. token [B, 1] -> (logits [B, 1, V], new cache).

    The new token's k / v are written into the cache's tensors in place
    (no copy of the cache a step); the returned dict holds them and
    ``cache_len + 1``."""
    check_family(cfg)
    x = _embed(cfg, params, token)
    cache_len = cache["cache_len"]
    positions = cache_len[:, None]
    for i, blk in enumerate(params.blocks):
        x = _self_attn(blk, x, positions, cfg,
                       decode=(cache["k"][i], cache["v"][i], cache_len))
        x = _ffn(blk, x, cfg)
    return _logits(cfg, params, x), dict(cache, cache_len=cache_len + 1)
