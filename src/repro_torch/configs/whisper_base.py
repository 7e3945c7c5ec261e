"""whisper-base [audio] — enc-dec, conv frontend stubbed as 1500 precomputed
frame embeddings. 6L d_model=512 8H (MHA) d_ff=2048 vocab=51865.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    norm="layernorm",
    use_bias=True,
    mlp_type="gelu",
    rope=False,
    learned_pos=True,     # learned positional embeddings
    max_pos=32768 + 8,    # sized for the assigned decode_32k shape
    enc_layers=6,
    enc_seq=1500,         # conv frontend stub: precomputed frame embeddings
    cross_attn=True,
    dtype="bfloat16",
)
