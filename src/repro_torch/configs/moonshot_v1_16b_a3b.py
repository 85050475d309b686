"""moonshot-v1-16b-a3b [moe]: 64 experts top-6 (kimi/moonlight).

hf:moonshotai/Moonlight-16B-A3B.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840, mlp_act="silu",
    num_experts=64, experts_per_token=6,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
