"""llama-3.2-vision-90b [vlm]: cross-attn image layers every 5th layer.

hf:meta-llama/Llama-3.2-11B-Vision (90B variant; unverified). The vision
encoder is a STUB per the shape card: input_specs() supplies precomputed
patch embeddings [B, num_frontend_tokens, d_model].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, mlp_act="silu", rope_theta=5e5,
    frontend="vision", num_frontend_tokens=1024, cross_attn_every=5,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
