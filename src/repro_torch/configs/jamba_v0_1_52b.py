"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 every 2nd layer, Mamba+attn 1:7 interleave
(period 8, attention at offset 4). [arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    norm="rmsnorm",
    mlp_type="swiglu",
    rope=False,            # jamba uses no positional encoding (mamba provides order)
    max_pos=8,             # unused table kept minimal (rope=False path)
    n_experts=16,
    moe_top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    ssm_state=16,
    d_inner=8192,
    conv_width=4,
    fsdp=True,
    dtype="bfloat16",
)
