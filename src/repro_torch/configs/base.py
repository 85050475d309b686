"""Architecture config schema + the shape cards assigned to this paper."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    # attention / projections
    qkv_bias: bool = False
    mlp_act: str = "silu"       # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # hybrid (recurrentgemma): pattern of R=recurrent, A=local-attention
    block_pattern: str = ""     # e.g. "RRA" repeated
    local_window: int = 0
    lru_width: int = 0          # 0 -> d_model
    # enc-dec / frontend
    encoder_layers: int = 0
    frontend: str = "none"      # none | audio | vision
    num_frontend_tokens: int = 0
    cross_attn_every: int = 0   # vlm: one cross-attn layer per this many
    # numerics
    dtype: str = "bfloat16"
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k (bounded per-token state)?"""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ModelConfig":
        """Smoke-test config: same family/wiring, tiny sizes."""
        if self.family == "hybrid":
            layers = len(self.block_pattern) or 3     # one full pattern
        elif self.family == "vlm":
            layers = 4                                # 2 cross-attn at every=2
        else:
            layers = 2
        return dataclasses.replace(
            self,
            num_layers=layers,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=96,
            vocab_size=503,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=8,
            local_window=min(self.local_window, 8) if self.local_window else 0,
            lru_width=64 if self.family == "hybrid" else 0,
            encoder_layers=min(self.encoder_layers, 2),
            num_frontend_tokens=(12 if self.num_frontend_tokens else 0),
            cross_attn_every=2 if self.cross_attn_every else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCard:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: dict[str, ShapeCard] = {
    "train_4k": ShapeCard("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCard("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCard("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCard("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's shape card rules."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k-token KV decode is "
                       "quadratic-prefill-gated; skipped per shape card "
                       "(runs only for ssm/hybrid)")
    return True, ""
