"""internvl2-1b [vlm] — InternViT frontend stubbed as precomputed patch
embeddings; Qwen2-0.5B-class LM backbone. 24L d_model=896 14H (GQA kv=2)
d_ff=4864 vocab=151655. [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    norm="rmsnorm",
    mlp_type="swiglu",
    rope=True,
    rope_theta=1e6,
    vlm_prefix=256,       # ViT patch-embedding stub prefix
    dtype="bfloat16",
)
