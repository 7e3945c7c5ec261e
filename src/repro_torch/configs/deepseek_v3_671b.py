"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048 (expert width)
vocab=129280, MLA (kv_lora 512 + rope 64), 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437; hf]

Dry-run notes: trained with FSDP sharding and bf16 optimizer state — fp32
AdamW moments for 671B params exceed v5e HBM at 512 chips (see DESIGN.md §5).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,         # MLA: cache is rank-compressed, not per-head
    d_ff=2048,              # routed-expert width (assigned spec)
    vocab_size=129280,
    norm="rmsnorm",
    mlp_type="swiglu",
    rope=True,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    n_experts=256,
    moe_top_k=8,
    n_shared_experts=1,
    capacity_factor=1.25,
    mtp=True,
    fsdp=True,
    opt="adafactor",           # factored 2nd moments: fp32 AdamW moments for
    opt_state_dtype="float32",  # 671B exceed v5e HBM at 512 chips (DESIGN.md §5)
    dtype="bfloat16",
)
