"""Decoder-only model assembly for the dense, moe, vlm, hybrid and ssm
families (port of ``repro.models.transformer``).

The parameters are an ``nn.Module`` (:class:`DecoderLM`) whose names are
the reference's pytree paths with the stacked axes as indices: the
reference's stacked ``blocks/attn/wq [L, D, H*hd]`` is the port's
``blocks.{i}.attn.wq [D, H*hd]``, one block per layer in a ``ModuleList``
(a Python loop over the layers takes the place of ``lax.scan``). The
heterogeneous stacks keep the reference's superblocks: vlm's
``blocks.{s}.{j}`` (``cross_attn_every`` dense blocks) and
``cross_blocks.{s}``, hybrid's ``blocks.{s}.b{i}`` (one per letter of
``block_pattern``) and the ``tail{i}`` blocks past the last whole pattern.
Weights keep the reference's ``x @ W`` layout and dtypes: the matrices, the
embedding, the expert stacks and the conv filters in ``cfg.dtype``; the
norm offsets, the router, the recurrences' parameters and the cross gate in
float32. Parameters are made with ``requires_grad=False``, as serving wants
them; the training step (``launch.steps.build_train_step``) turns gradients
on for the module it trains, and every parameter then receives one.

Decode writes the new k / v and recurrent states into the cache's tensors
in place: the stacked ``k`` / ``v`` [L, B, max_seq, KV, hd] (vlm [n_super,
every, ...], hybrid [n_super, n_attn, B, win, ...] ring-buffered over the
local window), ssm's ``conv`` [L, B, K, Di + 2N] and float32 ``h`` [L, B,
H, P, N], hybrid's ``conv`` and float32 ``lru_h``.

``forward(remat=True)``, the reference's default, recomputes each block
(vlm's and hybrid's superblocks) in the backward instead of keeping its
activations, with ``torch.utils.checkpoint`` where the reference calls
``jax.checkpoint``; it changes no result. ``opts`` reads the reference's
``moe_impl`` ("sort", or "einsum": the per-group one-hot dispatch, which
drops other pairs) and ``attn_block_dtype``. Its other XLA knobs
(``skip_future``, ``moe_shard_experts``, ``pad_heads_to``,
``shard_attn_heads``, ``decode_cache_in_carry``) change the compiled
program, not the result, and have no counterpart: fully masked future kv
chunks are always skipped.

Over a process-group mesh a rank's module holds its slices
(``models.model.shard``, ``DecoderLM.mp``) and the layers run Megatron's
tensor parallelism with ``distributed.tensor_parallel``'s operators: the
vocabulary-parallel embedding and head, the rank's q heads (and kv heads
where the rules split them) in self- and cross-attention, row-parallel
output projections and MLPs summed in float32 before their one rounding,
the MoE's experts (``models.moe``), Mamba-2's heads (``models.ssm``) and
the RG-LRU's width (``models.rglru``). The forward, loss and decode steps
take the rank's rows of the batch; ``mesh`` makes the MoE's routing the
whole batch's.
"""
from __future__ import annotations

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.tensor_parallel import data_ranks, model_axis
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_ffn
from repro_torch.models.rglru import recurrent_block
from repro_torch.models.ssm import mamba2_block

F32 = torch.float32
# the families whose forward scales a tied embedding by sqrt(d_model) (the
# reference's decode scales it for every family)
FORWARD_SCALED = ("dense", "moe", "vlm", "hybrid")


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

    def full(self, shape, value: float, dtype) -> nn.Parameter:
        return nn.Parameter(torch.full(shape, value, dtype=dtype,
                                       device=self.device),
                            requires_grad=False)

    def zeros(self, shape, dtype) -> nn.Parameter:
        return self.full(shape, 0.0, dtype)


def make_init(rng, device) -> _Init:
    """The draws of ``init_params``: ``rng`` is a seed or a
    ``torch.Generator`` on ``device`` (``cuda`` unless given)."""
    device = resolve_device(device)
    if isinstance(rng, torch.Generator) or device.type == "meta":
        gen = rng if isinstance(rng, torch.Generator) else None
    else:
        gen = torch.Generator(device=device).manual_seed(int(rng))
    return _Init(gen, device)


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


def _mlp(cfg: ModelConfig, init: _Init, dt) -> nn.Module:
    return (DenseMLP if cfg.mlp_act == "gelu_mlp" else GatedMLP)(
        cfg, init, dt)


class MoE(nn.Module):
    """The router (float32) and the expert stacks [E, D, F] / [E, F, D]."""

    def __init__(self, cfg: ModelConfig, init: _Init, dt):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.wr = init.normal((d, e), d ** -0.5, F32)
        self.wg = init.normal((e, d, f), d ** -0.5, dt)
        self.wu = init.normal((e, d, f), d ** -0.5, dt)
        self.wd = init.normal((e, f, d), f ** -0.5, dt)


class Block(nn.Module):
    """An attention block with an MLP, or with the experts (``moe``)."""

    def __init__(self, cfg: ModelConfig, init: _Init, dt, moe: bool = False):
        super().__init__()
        self.norm1 = init.zeros((cfg.d_model,), F32)
        self.attn = Attention(cfg, init, dt)
        self.norm2 = init.zeros((cfg.d_model,), F32)
        if moe:
            self.moe = MoE(cfg, init, dt)
        else:
            self.mlp = _mlp(cfg, init, dt)


class CrossBlock(nn.Module):
    """vlm's gated cross-attention block; ``gate`` is a float32 scalar."""

    def __init__(self, cfg: ModelConfig, init: _Init, dt):
        super().__init__()
        self.norm1 = init.zeros((cfg.d_model,), F32)
        self.attn = Attention(cfg, init, dt)
        self.norm2 = init.zeros((cfg.d_model,), F32)
        self.mlp = _mlp(cfg, init, dt)
        self.gate = init.zeros((), F32)


class LRU(nn.Module):
    def __init__(self, w: int, init: _Init):
        super().__init__()
        self.w_r = init.normal((w, w), w ** -0.5, F32)
        self.w_i = init.normal((w, w), w ** -0.5, F32)
        self.b_r = init.zeros((w,), F32)
        self.b_i = init.zeros((w,), F32)
        self.lam = init.full((w,), 0.5, F32)


class RecurrentBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, init: _Init, dt):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        self.norm1 = init.zeros((d,), F32)
        self.w_gate = init.normal((d, w), d ** -0.5, dt)
        self.w_branch = init.normal((d, w), d ** -0.5, dt)
        self.conv_w = init.normal((cfg.ssm_conv, w), 0.1, dt)
        self.conv_b = init.zeros((w,), dt)
        self.lru = LRU(w, init)
        self.w_out = init.normal((w, d), w ** -0.5, dt)
        self.norm2 = init.zeros((d,), F32)
        self.mlp = _mlp(cfg, init, dt)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, init: _Init, dt):
        super().__init__()
        d = cfg.d_model
        di = cfg.ssm_expand * d
        n = cfg.ssm_state
        nh = di // cfg.ssm_headdim
        self.norm1 = init.zeros((d,), F32)
        self.w_in = init.normal((d, 2 * di + 2 * n + nh), d ** -0.5, dt)
        self.conv_w = init.normal((cfg.ssm_conv, di + 2 * n), 0.1, dt)
        self.conv_b = init.zeros((di + 2 * n,), dt)
        self.A_log = init.zeros((nh,), F32)
        self.dt_bias = init.zeros((nh,), F32)
        self.D_skip = init.full((nh,), 1.0, F32)
        self.norm_scale = init.zeros((di,), F32)
        self.w_out = init.normal((di, d), di ** -0.5, dt)


def _pattern_block(c: str, cfg: ModelConfig, init: _Init, dt) -> nn.Module:
    return RecurrentBlock(cfg, init, dt) if c == "R" else Block(cfg, init, dt)


class Superblock(nn.Module):
    """hybrid: one block per letter of ``block_pattern``, ``b{i}``."""

    def __init__(self, cfg: ModelConfig, init: _Init, dt):
        super().__init__()
        for i, c in enumerate(cfg.block_pattern):
            setattr(self, f"b{i}", _pattern_block(c, cfg, init, dt))


def _hybrid_tail(cfg: ModelConfig) -> list[str]:
    """The letters of the blocks past the last whole pattern."""
    pat = cfg.block_pattern
    n_tail = cfg.num_layers - cfg.num_layers // len(pat) * len(pat)
    return [pat[i % len(pat)] for i in range(n_tail)]


class DecoderLM(nn.Module):
    """A decoder's parameters (the reference's params pytree). ``mp`` is
    the rank's ``tensor_parallel.ModelParallel`` where the module holds a
    rank's slices (``models.model.shard``), else None."""

    mp = None

    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        dt = torch_dtype(cfg)
        fam = cfg.family
        self.embed = init.normal((cfg.vocab_size, cfg.d_model), 0.02, dt)
        self.final_norm = init.zeros((cfg.d_model,), F32)
        if not cfg.tie_embeddings:
            self.lm_head = init.normal((cfg.d_model, cfg.vocab_size),
                                       cfg.d_model ** -0.5, dt)
        if fam in ("dense", "moe"):
            self.blocks = nn.ModuleList(Block(cfg, init, dt, fam == "moe")
                                        for _ in range(cfg.num_layers))
        elif fam == "vlm":
            every = cfg.cross_attn_every
            n_super = cfg.num_layers // every
            self.blocks = nn.ModuleList(
                nn.ModuleList(Block(cfg, init, dt) for _ in range(every))
                for _ in range(n_super))
            self.cross_blocks = nn.ModuleList(CrossBlock(cfg, init, dt)
                                              for _ in range(n_super))
        elif fam == "hybrid":
            n_super = cfg.num_layers // len(cfg.block_pattern)
            self.blocks = nn.ModuleList(Superblock(cfg, init, dt)
                                        for _ in range(n_super))
            for i, c in enumerate(_hybrid_tail(cfg)):
                setattr(self, f"tail{i}", _pattern_block(c, cfg, init, dt))
        elif fam == "ssm":
            self.blocks = nn.ModuleList(SSMBlock(cfg, init, dt)
                                        for _ in range(cfg.num_layers))
        else:
            raise ValueError(f"family {fam} not handled here")

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
    biases and norm offsets; its constants), not its values.
    ``device="meta"`` gives shapes and dtypes only, with no draws."""
    return DecoderLM(cfg, make_init(rng, device))


def abstract_params(cfg: ModelConfig) -> DecoderLM:
    return init_params(cfg, device="meta")


# ================================================================ forward ===
def _embed(cfg: ModelConfig, params: DecoderLM, tokens,
           scale: bool = True) -> torch.Tensor:
    """Token embeddings in ``cfg.dtype``; tied ones (when ``scale``) times
    sqrt(d_model) rounded to that dtype first, as the reference's
    ``x * jnp.asarray(d_model ** 0.5, dt)`` (39.25 for 1 536 in bf16).
    With the vocabulary split over the model axis, the ranks' lookups
    summed (``layers.vocab_embed``)."""
    dt = torch_dtype(cfg)
    tokens = torch.as_tensor(tokens, device=params.device).long()
    x = L.vocab_embed(params.embed, tokens, params.mp).to(dt)
    if scale and cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x


def _self_attn(blk: Block, x, positions, cfg: ModelConfig, window: int = 0,
               decode=None, opts: dict | None = None, mp=None):
    """x plus self-attention on its norm. With ``mp`` the rank attends with
    its q heads (``qkv_project``), each reading the kv head of its global
    index (``kv_for_heads``), and the output projection is summed over the
    model axis (``out_project``)."""
    h = L.rms_norm(x, blk.norm1, cfg.norm_eps)
    q, k, v = L.qkv_project(blk.attn, h, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim, mp)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if decode is not None:
        k_cache, v_cache, cache_len = decode
        # write the current kv at cache_len mod size (a ring buffer for
        # local windows), in place
        size = k_cache.shape[1]
        idx = torch.remainder(cache_len, size).long()
        bidx = torch.arange(k.shape[0], device=k.device)
        k_cache[bidx, idx] = k[:, 0]
        v_cache[bidx, idx] = v[:, 0]
        k_cache = L.kv_for_heads(k_cache, mp)
        v_cache = L.kv_for_heads(v_cache, mp)
        if window and size <= window:
            # the ring holds exactly the window: every written entry counts
            o = L.decode_attention(q, k_cache, v_cache,
                                   torch.clamp(cache_len + 1, max=size))
        else:
            o = L.decode_attention(q, k_cache, v_cache, cache_len + 1,
                                   window=window)
        return x + L.out_project(blk.attn, o, mp)
    o = L.attention(q, L.kv_for_heads(k, mp), L.kv_for_heads(v, mp),
                    q_offset=0, causal=True, window=window,
                    block_dtype=(opts or {}).get("attn_block_dtype",
                                                 "float32"))
    return x + L.out_project(blk.attn, o, mp)


def _ffn(blk, x, cfg: ModelConfig, opts: dict | None = None, mp=None,
         dp=None):
    """x plus the block's MLP (or experts) on its norm; returns (x, aux).
    ``mp`` / ``dp``: the model and data ranks (``moe.moe_ffn``)."""
    h = L.rms_norm(x, blk.norm2, cfg.norm_eps)
    moe = getattr(blk, "moe", None)
    if moe is not None:
        y, aux = moe_ffn(moe, h, num_experts=cfg.num_experts,
                         experts_per_token=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor,
                         act=cfg.mlp_act,
                         impl=(opts or {}).get("moe_impl", "sort"),
                         mp=mp, dp=dp)
        return x + y, aux
    if cfg.mlp_act == "gelu_mlp":
        return x + L.dense_mlp(blk.mlp, h, "gelu", mp), 0.0
    return x + L.gated_mlp(blk.mlp, h, cfg.mlp_act, mp), 0.0


def _gated(blk: CrossBlock, x, o, mp=None):
    """``tanh(gate) * out_project(o)`` in float32, rounded to x's dtype;
    with ``mp`` the gate multiplies the row-parallel projection after its
    sum and one rounding, in the reference's order."""
    out = L.out_project(blk.attn, o, mp)
    return x + (torch.tanh(blk.gate) * out.to(F32)).to(x.dtype)


def _cross_attn(blk: CrossBlock, x, kv_src, cfg: ModelConfig, mp=None):
    """Gated cross-attention to the (precomputed) vision embeddings, then
    the block's own MLP; with ``mp`` on the rank's q heads, each reading
    the kv head of its global index (``layers.kv_for_heads``)."""
    h = L.rms_norm(x, blk.norm1, cfg.norm_eps)
    q, _, _ = L.qkv_project(blk.attn, h, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim, mp)
    k, v = L.kv_project(blk.attn, kv_src, cfg.resolved_head_dim, mp,
                        dtype=x.dtype)
    o = L.attention(q, L.kv_for_heads(k, mp), L.kv_for_heads(v, mp),
                    causal=False)
    x, _ = _ffn(blk, _gated(blk, x, o, mp), cfg, mp=mp)
    return x


def _rec_block(blk: RecurrentBlock, x, cfg: ModelConfig, decode_state=None,
               mp=None):
    h = L.rms_norm(x, blk.norm1, cfg.norm_eps)
    y, new_state = recurrent_block(blk, h, decode_state, mp)
    x, _ = _ffn(blk, x + y, cfg, mp=mp)
    return x, new_state


def _ssm_block(blk: SSMBlock, x, cfg: ModelConfig, decode_state=None,
               mp=None):
    h = L.rms_norm(x, blk.norm1, cfg.norm_eps)
    y, new_state = mamba2_block(blk, h, headdim=cfg.ssm_headdim,
                                d_state=cfg.ssm_state, chunk=cfg.ssm_chunk,
                                decode_state=decode_state, mp=mp)
    return x + y, new_state


def _hybrid_blocks(cfg: ModelConfig, params: DecoderLM):
    """hybrid's blocks in order: (letter, block, attention slot, recurrent
    slot), the slots as the cache indexes them (superblock, index) or
    ``tail{i}``."""
    pat = cfg.block_pattern
    for s, sb in enumerate(params.blocks):
        ai = ri = 0
        for i, c in enumerate(pat):
            yield c, getattr(sb, f"b{i}"), (s, ai if c == "A" else ri)
            ai += c == "A"
            ri += c == "R"
    for i, c in enumerate(_hybrid_tail(cfg)):
        yield c, getattr(params, f"tail{i}"), f"tail{i}"


def _logits(cfg: ModelConfig, params: DecoderLM, x,
            vocab_block: bool = False) -> torch.Tensor:
    """Float32 logits [..., V]. With the vocabulary split over the model
    axis the rank's head is its vocab block (a tied embedding's rows are
    the same block): ``vocab_block`` returns that block [..., V / m], else
    the blocks are gathered whole."""
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return L.vocab_logits(x, params.head(), params.mp, vocab_block)


def _remat(fn, remat: bool, params: nn.Module):
    """``fn``, recomputed in the backward (``jax.checkpoint``'s place) when
    ``remat`` and a graph is being recorded for the parameters; as is
    otherwise (serving records none, so the wrapper would only cost)."""
    if not (remat and torch.is_grad_enabled()
            and any(p.requires_grad for p in params.parameters())):
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 preserve_rng_state=False)


def forward(cfg: ModelConfig, params: DecoderLM, tokens,
            frontend_embeds=None, *, remat: bool = True,
            opts: dict | None = None, mesh=None, vocab_block: bool = False):
    """Token logits for train / prefill. tokens [B, S] -> logits [B, S, V]
    float32; vlm attends to ``frontend_embeds`` [B, T, D].

    Returns (logits, aux_loss): moe's summed Switch losses (float32), 0.0
    for the other families. ``remat`` recomputes each block (vlm's and
    hybrid's superblocks; hybrid's tail blocks are not, as in the
    reference) in the backward; the recomputation reissues the block's
    collectives, in the same order on every rank.

    On a process-group ``mesh`` the tokens are this rank's rows of the
    global batch; the module holds the rank's slices (``params.mp``), and
    ``mesh``'s data ranks make the MoE's routing a function of the whole
    batch (``moe.moe_ffn``). ``vocab_block``: the rank's vocab block of
    the logits, not the whole (:func:`_logits`)."""
    fam = cfg.family
    mp, dp = params.mp, data_ranks(mesh)
    x = _embed(cfg, params, tokens, scale=fam in FORWARD_SCALED)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    auxs = []
    if fam in ("dense", "moe"):
        def blk_fn(x, blk):
            x = _self_attn(blk, x, positions, cfg, opts=opts, mp=mp)
            return _ffn(blk, x, cfg, opts, mp, dp)

        blk_fn = _remat(blk_fn, remat, params)
        for blk in params.blocks:
            x, aux = blk_fn(x, blk)
            auxs.append(aux)
    elif fam == "vlm":
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name} attends to frontend_embeds "
                             "[B, T, D]; none given")
        kv_src = torch.as_tensor(frontend_embeds, device=x.device)

        def super_fn(x, selfs, cross):
            for blk in selfs:
                x = _self_attn(blk, x, positions, cfg, opts=opts, mp=mp)
                x, _ = _ffn(blk, x, cfg, opts, mp)
            return _cross_attn(cross, x, kv_src, cfg, mp)

        super_fn = _remat(super_fn, remat, params)
        for selfs, cross in zip(params.blocks, params.cross_blocks):
            x = super_fn(x, selfs, cross)
    elif fam == "hybrid":
        def pattern_blk(c, blk, x):
            if c == "R":
                return _rec_block(blk, x, cfg, mp=mp)[0]
            x = _self_attn(blk, x, positions, cfg, window=cfg.local_window,
                           opts=opts, mp=mp)
            return _ffn(blk, x, cfg, opts, mp)[0]

        def super_fn(x, sb):
            for i, c in enumerate(cfg.block_pattern):
                x = pattern_blk(c, getattr(sb, f"b{i}"), x)
            return x

        super_fn = _remat(super_fn, remat, params)
        for sb in params.blocks:
            x = super_fn(x, sb)
        for i, c in enumerate(_hybrid_tail(cfg)):
            x = pattern_blk(c, getattr(params, f"tail{i}"), x)
    else:   # ssm
        def blk_fn(x, blk):
            return _ssm_block(blk, x, cfg, mp=mp)[0]

        blk_fn = _remat(blk_fn, remat, params)
        for blk in params.blocks:
            x = blk_fn(x, blk)
    aux = torch.stack(auxs).sum() if fam == "moe" else 0.0
    return _logits(cfg, params, x, vocab_block), aux


# ================================================================= decode ===
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None, mesh=None) -> dict:
    """The decode cache on ``device`` (``cuda`` unless given): the
    reference's ``init_cache`` layout for ``cfg.family``, zeros, with
    ``cache_len`` int32[B]. vlm's ``cross_k`` / ``cross_v`` [n_super, B, T,
    KV, hd] hold T = ``cfg.num_frontend_tokens``.

    On a process-group ``mesh``: this rank's part of a cache of ``batch``
    global rows, its rows over the data ranks and, over the model axis,
    its kv heads (self and cross) where the rules split them, its
    Mamba-2 heads' x channels in ``conv`` (with every B and C channel) and
    heads in ``h``, and its RG-LRU channels in ``conv`` and ``lru_h``.
    Where the kv heads do not divide the axis the reference splits the
    cache's sequence instead (``sharding.cache_spec_tree``); here each rank
    holds every kv head, the same function at more memory."""
    device = resolve_device(device)
    dt = torch_dtype(cfg)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    fam = cfg.family
    dp = data_ranks(mesh)
    if dp is not None:
        rows = dp.rows(batch)
        batch = rows.stop - rows.start
    m = model_axis(mesh)
    if m > 1 and kv % m == 0:
        kv //= m

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache = dict(cache_len=zeros(batch, dtype=torch.int32))
    if fam in ("dense", "moe"):
        cache["k"] = zeros(cfg.num_layers, batch, max_seq, kv, hd)
        cache["v"] = zeros(cfg.num_layers, batch, max_seq, kv, hd)
    elif fam == "vlm":
        every = cfg.cross_attn_every
        n_super = cfg.num_layers // every
        t = cfg.num_frontend_tokens
        cache["k"] = zeros(n_super, every, batch, max_seq, kv, hd)
        cache["v"] = zeros(n_super, every, batch, max_seq, kv, hd)
        cache["cross_k"] = zeros(n_super, batch, t, kv, hd)
        cache["cross_v"] = zeros(n_super, batch, t, kv, hd)
    elif fam == "hybrid":
        pat = cfg.block_pattern
        n_super = cfg.num_layers // len(pat)
        n_attn, n_rec = pat.count("A"), pat.count("R")
        w = cfg.lru_width or cfg.d_model
        w = w // m if w % m == 0 else w
        win = min(cfg.local_window, max_seq)
        cache["k"] = zeros(n_super, n_attn, batch, win, kv, hd)
        cache["v"] = zeros(n_super, n_attn, batch, win, kv, hd)
        cache["lru_h"] = zeros(n_super, n_rec, batch, w, dtype=F32)
        cache["conv"] = zeros(n_super, n_rec, batch, cfg.ssm_conv, w)
        for i, c in enumerate(_hybrid_tail(cfg)):
            if c == "R":
                cache[f"tail{i}_h"] = zeros(batch, w, dtype=F32)
                cache[f"tail{i}_conv"] = zeros(batch, cfg.ssm_conv, w)
            else:
                cache[f"tail{i}_k"] = zeros(batch, win, kv, hd)
                cache[f"tail{i}_v"] = zeros(batch, win, kv, hd)
    elif fam == "ssm":
        di = cfg.ssm_expand * cfg.d_model
        nh = di // cfg.ssm_headdim
        if sh.ssm_split(cfg, m):
            di, nh = di // m, nh // m
        cache["conv"] = zeros(cfg.num_layers, batch, cfg.ssm_conv,
                              di + 2 * cfg.ssm_state)
        cache["h"] = zeros(cfg.num_layers, batch, nh, cfg.ssm_headdim,
                           cfg.ssm_state, dtype=F32)
    else:
        raise ValueError(f"family {fam} not handled here")
    return cache


def _state(cache: dict, slot, conv: str, h: str):
    """A recurrent layer's (conv, h) views of the cache at ``slot``."""
    if isinstance(slot, str):
        return cache[f"{slot}_conv"], cache[f"{slot}_h"]
    return cache[conv][slot], cache[h][slot]


def _write_state(views, new) -> None:
    for view, value in zip(views, new):
        view.copy_(value)


def decode_step(cfg: ModelConfig, params: DecoderLM, cache: dict, token,
                mesh=None):
    """One decode step. token [B, 1] -> (logits [B, 1, V], cache).

    The new token's k / v and recurrent states are written into the
    cache's tensors in place (no copy of the cache a step); the returned
    dict holds them and ``cache_len + 1``. A tied embedding is scaled for
    every family, as the reference's decode does. On a process-group
    ``mesh`` the token and the cache are this rank's rows (as
    :func:`forward`'s); the logits are whole over the vocabulary."""
    fam = cfg.family
    mp, dp = params.mp, data_ranks(mesh)
    x = _embed(cfg, params, token)
    cache_len = cache["cache_len"]
    positions = cache_len[:, None]
    if fam in ("dense", "moe"):
        for i, blk in enumerate(params.blocks):
            x = _self_attn(blk, x, positions, cfg,
                           decode=(cache["k"][i], cache["v"][i], cache_len),
                           mp=mp)
            x, _ = _ffn(blk, x, cfg, mp=mp, dp=dp)
    elif fam == "vlm":
        b = x.shape[0]
        for s, (selfs, cross) in enumerate(zip(params.blocks,
                                               params.cross_blocks)):
            for j, blk in enumerate(selfs):
                x = _self_attn(blk, x, positions, cfg, decode=(
                    cache["k"][s, j], cache["v"][s, j], cache_len), mp=mp)
                x, _ = _ffn(blk, x, cfg, mp=mp)
            # cross attention against the cached cross k / v (the rank's
            # kv heads where the rules split them)
            h = L.rms_norm(x, cross.norm1, cfg.norm_eps)
            q, _, _ = L.qkv_project(cross.attn, h, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.resolved_head_dim,
                                    mp)
            ck = L.kv_for_heads(cache["cross_k"][s], mp)
            cv = L.kv_for_heads(cache["cross_v"][s], mp)
            o = L.decode_attention(q, ck, cv, torch.full(
                (b,), ck.shape[1], dtype=torch.int32, device=x.device))
            x, _ = _ffn(cross, _gated(cross, x, o, mp), cfg, mp=mp)
    elif fam == "hybrid":
        for c, blk, slot in _hybrid_blocks(cfg, params):
            if c == "R":
                views = _state(cache, slot, "conv", "lru_h")
                x, new = _rec_block(blk, x, cfg, views, mp)
                _write_state(views, new)
            else:
                kv = ((cache[f"{slot}_k"], cache[f"{slot}_v"])
                      if isinstance(slot, str)
                      else (cache["k"][slot], cache["v"][slot]))
                x = _self_attn(blk, x, positions, cfg,
                               window=cfg.local_window,
                               decode=(*kv, cache_len), mp=mp)
                x, _ = _ffn(blk, x, cfg, mp=mp)
    else:   # ssm
        for i, blk in enumerate(params.blocks):
            views = _state(cache, i, "conv", "h")
            x, new = _ssm_block(blk, x, cfg, views, mp)
            _write_state(views, new)
    return _logits(cfg, params, x), dict(cache, cache_len=cache_len + 1)
