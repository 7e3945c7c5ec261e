"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    norm="rmsnorm",
    mlp_type="swiglu",
    rope=True,
    rope_theta=1e6,
    sliding_window=4096,   # SWA => long_500k decode cache is window-capped
    n_experts=8,
    moe_top_k=2,
    fsdp=True,
    dtype="bfloat16",
)
