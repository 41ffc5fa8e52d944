"""gemma-2b [dense] — GeGLU, head_dim=256, MQA.

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=256000.
[arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=256_000,
    head_dim=256,
    mlp_variant="geglu",
    tie_embeddings=True,
    supports_long_context=False,
    source="arXiv:2403.08295; hf",
))
