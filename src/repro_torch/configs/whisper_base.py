"""whisper-base [audio] — encoder-decoder, conv frontend stubbed.

6L d_model=512 8H (kv=8, i.e. MHA) d_ff=2048 vocab=51865.
[arXiv:2212.04356; unverified]  The conv1d audio frontend is a STUB:
input_specs() provides precomputed 1500-frame embeddings (30 s of audio at
50 Hz after the conv stride-2); the transformer backbone (6 encoder + 6
decoder layers with cross-attention) is fully implemented.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,            # decoder layers
    encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    head_dim=64,
    mlp_variant="gelu",
    tie_embeddings=True,
    supports_long_context=False,  # full attention
    source="arXiv:2212.04356; unverified",
))
