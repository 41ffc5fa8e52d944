"""olmoe-1b-7b [moe] — 64 experts, top-8.

16L d_model=2048 16H (kv=16, MHA) expert d_ff=1024 vocab=50304.
[arXiv:2409.02060; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=50_304,
    head_dim=128,
    mlp_variant="swiglu",
    tie_embeddings=False,
    num_experts=64,
    num_experts_per_token=8,
    moe_d_ff=1024,
    supports_long_context=False,
    source="arXiv:2409.02060; hf",
))
