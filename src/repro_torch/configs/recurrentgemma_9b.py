"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 ratio.

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000.
[arXiv:2402.19427; unverified]  Griffin layout: two recurrent (RG-LRU)
blocks followed by one local-attention block; 38 layers = (2+1) does not
divide 38, so per the Griffin paper the final pattern truncates — we round
to the nearest pattern-aligned depth (39 -> 38 is not period-aligned, we
keep 38 via period (rglru, rglru, local) x 12 + 2 extra rglru folded as a
13th truncated group; implemented as 36 pattern layers + 2 rglru by using
period-aligned 36? No: we keep EXACTLY 38 layers by using a pattern of
length 19 (12 full (r,r,l) groups + (r,r)) repeated twice).
"""
from repro_torch.configs.base import ModelConfig, register

_PERIOD = (("rglru", "rglru", "local") * 6 + ("rglru",))  # 19 layers

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256_000,
    head_dim=256,
    mlp_variant="geglu",
    tie_embeddings=True,
    layer_pattern=_PERIOD,
    window_size=2048,
    rnn_width=4096,
    supports_long_context=True,   # bounded window + constant RG-LRU state
    source="arXiv:2402.19427; unverified",
))
