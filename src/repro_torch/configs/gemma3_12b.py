"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
[hf:google/gemma-3-1b-pt; unverified]  Pattern period: 5 sliding-window
layers (1024 window) then 1 global layer.  The hybrid pattern bounds the
KV cache of 5/6 of the layers, so long_500k is runnable with the global
layers' cache sequence-sharded (see DESIGN.md Section 7).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262_144,
    head_dim=256,
    mlp_variant="geglu",
    tie_embeddings=True,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window_size=1024,
    rope_theta=1_000_000.0,
    supports_long_context=True,
    source="hf:google/gemma-3-1b-pt; unverified",
))
