"""falcon-mamba-7b [ssm] — 64L d_model=4096 attention-free, ssm_state=16,
vocab=65024, mamba1 architecture. [arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                # mamba1 block has no separate FFN
    vocab_size=65024,
    norm="rmsnorm",
    rope=False,
    max_pos=8,             # unused (attention-free)
    ssm_state=16,
    d_inner=8192,
    conv_width=4,
    tie_embeddings=True,
    # (JAX reference, TPU dry-run) §Perf iteration 3 tried tp_mode="dp"
    # (model axis -> extra DP): REFUTED —
    # memory term regressed 43s -> 197s (batch/dev shrank 16x but the fp32
    # scan state didn't, while FSDP gathers added traffic). Reverted to TP.
    dtype="bfloat16",
)
