"""The work functions against torch's own FLOP counter on the reference."""
import importlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import inputs
from gpubench.reference import diffusion as ref, kind
from gpubench.work import groupnorm_stitch, patch_attention
from gpubench_tiny import KIND_TINY, KINDS, TINY_UNET

SHAPES = [(16, 16), (24, 32), (32, 32)]


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("cfg", KIND_TINY + [dict(TINY_UNET, levels=3, blocks_per_level=2,
                                                  attn_levels=[1, 2])],
                         ids=KINDS + ["unet-3-levels"])
@pytest.mark.parametrize("H,W", SHAPES)
def test_model_flops_equal_the_counter_on_one_reference_step(cfg, H, W):
    work = importlib.import_module(f"gpubench.work.{cfg['kind']}")
    P = inputs.model_weights(cfg, 3, "cpu")
    x = torch.randn(1, cfg["latent_channels"], H, W)
    cond = {name: torch.randn(shape) for name, shape, _ in kind(cfg).conditioning(cfg)}
    n = counted(lambda: kind(cfg).forward(ref.Arith(), cfg, P, x, torch.tensor(500.0), **cond))
    assert work.flops(cfg, H, W) == n


@pytest.mark.parametrize("B,Sq,H,D,Sk", [(1, 256, 2, 40, 256), (3, 64, 4, 72, 77),
                                         (2, 100, 1, 16, 300)])
def test_attention_flops_equal_the_counter(B, Sq, H, D, Sk):
    q, k, v = (torch.randn(B * H, s, D) for s in (Sq, Sk, Sk))
    assert patch_attention.flops(B, Sq, H, D, Sk) == counted(lambda: ref.attention(ref.Arith(), q, k, v))
    assert patch_attention.nbytes(B, Sq, H, D, Sk, 4) == 4 * (2 * B * Sq * H * D + 2 * B * Sk * H * D)


def test_bounds_take_the_larger_term():
    # S = 4096, D = 40, H = 8: the flop term (4.3e10 / 989e12) beats the bytes term
    call = (1, 4096, 8, 40, 4096, 4)
    assert patch_attention.bound_s(call) == pytest.approx(4 * 8 * 4096 ** 2 * 40 / 989e12)
    # text keys under image queries: bytes bound
    call = (1, 4096, 16, 72, 120, 4)
    assert patch_attention.bound_s(call) == pytest.approx(4 * 16 * 72 * (2 * 4096 + 240) / 3.35e12)
    gn = (29, 32, 32, 320, 32, 4)
    assert groupnorm_stitch.bound_s(gn) == pytest.approx(
        (4 * 29 * 320 * (32 * 32 + 34 * 34) + 8 * 320) / 3.35e12)
