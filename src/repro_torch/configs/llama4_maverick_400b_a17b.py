"""llama4-maverick-400b-a17b [moe]: 128 experts top-1, early fusion stub.

hf:meta-llama/Llama-4-Scout-17B-16E (maverick variant; unverified).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, mlp_act="silu", rope_theta=5e5,
    num_experts=128, experts_per_token=1,
    frontend="vision", num_frontend_tokens=0,  # early-fusion stub: tokens only
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
