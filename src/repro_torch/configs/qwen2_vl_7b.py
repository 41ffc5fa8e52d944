"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (frontend stubbed).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
[arXiv:2409.12191; hf]  Backbone only per the assignment: input_specs()
provides precomputed patch embeddings merged into the token stream; M-RoPE
position ids are 3D (temporal, height, width).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152_064,
    head_dim=128,
    mlp_variant="swiglu",
    qkv_bias=True,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    mrope=True,
    supports_long_context=False,  # full attention
    source="arXiv:2409.12191; hf",
))
