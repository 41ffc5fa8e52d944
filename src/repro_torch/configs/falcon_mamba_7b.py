"""falcon-mamba-7b [ssm] — mamba1 architecture, attention-free.

64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16.
[arXiv:2410.05355; unverified]  Pure selective-SSM stack; constant-size
recurrent state makes every long-context cell runnable.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65_024,
    head_dim=0,
    layer_pattern=("ssm",),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=False,
    supports_long_context=True,
    source="arXiv:2410.05355; unverified",
))
