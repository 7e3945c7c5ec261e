"""Config schema for every architecture the framework can instantiate.

A copy of the JAX reference's ``repro/configs/base.py`` (pure dataclasses),
plus ``torch_dtype``. The parity tests build reduced same-family configs via
``reduced()``, which gives exactly the reference's configs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    use_bias: bool = False
    mlp_type: str = "swiglu"         # swiglu | gelu
    rope: bool = True
    rope_theta: float = 10000.0
    learned_pos: bool = False        # learned absolute positions (whisper)
    max_pos: int = 32768             # learned-pos-embedding table size
    tie_embeddings: bool = False
    sliding_window: int = 0          # 0 = full attention
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1               # MoE replaces dense FFN every k-th layer
    moe_offset: int = 0              # layer index % moe_every == moe_offset -> MoE
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    mla: Optional[MLAConfig] = None
    # --- SSM / hybrid (mamba, jamba) ---
    ssm_state: int = 0
    d_inner: int = 0
    conv_width: int = 4
    dt_rank: int = 0                 # 0 -> ceil(d_model / 16)
    attn_period: int = 0             # hybrid: one attn layer per period
    attn_offset: int = 0
    # --- encoder-decoder / multimodal frontend ---
    enc_layers: int = 0
    enc_seq: int = 0                 # stub frontend sequence (whisper frames / ViT patches)
    cross_attn: bool = False
    vlm_prefix: int = 0              # VLM: image-token prefix length (stub embeddings)
    # --- extras ---
    mtp: bool = False                # deepseek multi-token-prediction head
    # --- numerics / distribution hints ---
    flash_min_seq: int = 2048        # stream attention above this seq length
    dtype: str = "bfloat16"
    fsdp: bool = False               # shard params over "data" too (ZeRO-3 style)
    tp_mode: str = "tp"              # tp | dp: "dp" maps the "model" mesh axis
    opt: str = "adamw"               #   to extra data parallelism (small models
                                     #   whose per-layer TP collectives dominate)
    opt_state_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a multiple of 256 so the vocab dim TP-shards."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank if self.dt_rank else -(-self.d_model // 16)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def period(self) -> int:
        """Length of the repeating layer-type pattern."""
        if self.attn_period:
            return self.attn_period
        return max(self.moe_every, 1)

    def layer_plan(self) -> Tuple[Tuple[str, str], ...]:
        """One (mixer, ffn) pair per slot in the repeating period."""
        plan = []
        for i in range(self.period):
            if self.family == "ssm":
                mixer = "mamba"
            elif self.attn_period:
                mixer = "attn" if i % self.attn_period == self.attn_offset else "mamba"
            elif self.mla is not None:
                mixer = "mla"
            else:
                mixer = "attn"
            if self.family == "ssm":
                ffn = "none"                      # mamba1 block has no separate FFN
            elif self.n_experts and i % self.moe_every == self.moe_offset:
                ffn = "moe"
            else:
                ffn = "dense"
            plan.append((mixer, ffn))
        return tuple(plan)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (self.name, self.n_layers, self.period)
        return self.n_layers // self.period

    def reduced(self, **over) -> "ModelConfig":
        """A tiny same-family config exercising identical code paths on CPU."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=self.period * min(self.n_periods, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            enc_seq=min(self.enc_seq, 16) if self.enc_seq else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            vlm_prefix=min(self.vlm_prefix, 4) if self.vlm_prefix else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            d_inner=128 if self.d_inner else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            dt_rank=8 if self.family in ("ssm", "hybrid") else 0,
            mla=MLAConfig(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
                          qk_rope_head_dim=8, v_head_dim=16) if self.mla else None,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            max_pos=512,
            dtype="float32",
            fsdp=False,
            remat=False,
        )
        kw.update(over)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, spec: ShapeSpec) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is live, plus the reason when skipped."""
    if spec.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid")
            or cfg.sliding_window > 0
        )
        if not sub_quadratic:
            return False, "pure full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """``cfg.dtype`` ("float32", "bfloat16", ...) as a torch dtype."""
    dt = getattr(torch, cfg.dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return dt
