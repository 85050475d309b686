"""whisper-small [audio]: enc-dec, conv frontend stubbed. arXiv:2212.04356."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    mlp_act="gelu_mlp",        # whisper uses plain GELU MLP (non-gated)
    qkv_bias=True,
    encoder_layers=12, frontend="audio", num_frontend_tokens=1500,
    source="arXiv:2212.04356; unverified",
)
