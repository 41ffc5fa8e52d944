"""qwen2-72b [dense] — GQA with QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
[arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152_064,
    head_dim=128,
    mlp_variant="swiglu",
    qkv_bias=True,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    supports_long_context=False,
    source="arXiv:2407.10671; hf",
))
