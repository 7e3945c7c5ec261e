"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, LayerNorm, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    norm="layernorm",
    use_bias=False,
    mlp_type="swiglu",
    rope=True,
    rope_theta=8e6,
    tie_embeddings=True,  # command-r ties input/output embeddings
    fsdp=True,
    dtype="bfloat16",
)
