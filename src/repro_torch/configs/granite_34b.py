"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, llama-arch, code model. [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,        # MQA: KV replicated across the model axis
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    norm="layernorm",
    use_bias=True,       # granite-34b-code uses bias + layernorm (gpt-bigcode lineage)
    mlp_type="gelu",
    rope=True,
    fsdp=True,
    # §Perf iteration 2b: sequence-parallel activations (MQA K/V is tiny)
    tp_mode="sp",
    dtype="bfloat16",
)
