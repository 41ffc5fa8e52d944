"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8.

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936.
[hf:Qwen/Qwen3-30B-A3B; hf]  Every layer is MoE; the expert FFN runs as a
block-diagonal BCSR SpMM (the paper's blocked regime; DESIGN.md Section 6).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=151_936,
    head_dim=128,
    mlp_variant="swiglu",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    num_experts=128,
    num_experts_per_token=8,
    moe_d_ff=1536,
    supports_long_context=False,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
