"""recurrentgemma-9b [hybrid]: RG-LRU + local attn at 1:2. arXiv:2402.19427.

38 layers in repeating (R, R, A) pattern; MQA local attention window 2048;
GeGLU MLP; head_dim 256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256000, mlp_act="gelu",
    block_pattern="RRA", local_window=2048, lru_width=4096,
    tie_embeddings=True,
    source="arXiv:2402.19427; unverified",
)
