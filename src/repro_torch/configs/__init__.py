"""Architecture registry: ``get_config(arch_id)`` -> ModelConfig.

The ten public-literature LM architectures of the JAX reference's
``repro.configs``, copied as they are.
"""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, MLAConfig, ModelConfig, ShapeSpec, shape_applicable, torch_dtype)

from repro_torch.configs.whisper_base import CONFIG as whisper_base
from repro_torch.configs.internvl2_1b import CONFIG as internvl2_1b
from repro_torch.configs.command_r_35b import CONFIG as command_r_35b
from repro_torch.configs.internlm2_1_8b import CONFIG as internlm2_1_8b
from repro_torch.configs.granite_34b import CONFIG as granite_34b
from repro_torch.configs.starcoder2_3b import CONFIG as starcoder2_3b
from repro_torch.configs.mixtral_8x7b import CONFIG as mixtral_8x7b
from repro_torch.configs.deepseek_v3_671b import CONFIG as deepseek_v3_671b
from repro_torch.configs.jamba_v0_1_52b import CONFIG as jamba_v0_1_52b
from repro_torch.configs.falcon_mamba_7b import CONFIG as falcon_mamba_7b

ARCHS = {
    c.name: c for c in [
        whisper_base, internvl2_1b, command_r_35b, internlm2_1_8b,
        granite_34b, starcoder2_3b, mixtral_8x7b, deepseek_v3_671b,
        jamba_v0_1_52b, falcon_mamba_7b,
    ]
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return ARCHS[arch]
