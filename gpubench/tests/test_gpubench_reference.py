"""The plain reference against the program at tiny widths on the CPU. The
test imports both; the reference imports nothing of the program."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import inputs, serve, traffic as tm
from gpubench.reference import diffusion as ref, kind
from gpubench.reference.params import model_specs, vae_specs
from gpubench_tiny import KINDS, tiny_traffic
from repro_torch.models.diffusion import init_diffusion
from repro_torch.models.vae import init_vae

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.json"))
# each kind's tiny configuration: a kind's module brings its own cases
TINY = [kind({"kind": k}).TINY for k in KINDS]


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


@pytest.mark.parametrize("cfg", [json.loads(p.read_text()) for p in CONFIGS] + TINY,
                         ids=[p.stem for p in CONFIGS] + [c["name"] for c in TINY])
def test_specs_are_the_programs_trees(cfg):
    port = flat(init_diffusion(serve.diffusion_config(cfg), None, device="meta"))
    assert {p: s for p, s, _, _ in model_specs(cfg)} == port
    vae = flat(init_vae(None, cfg["latent_channels"], cfg["vae_width"], device="meta"))
    assert {p: s for p, s, _, _ in vae_specs(cfg)} == vae


@pytest.mark.parametrize("cfg", TINY, ids=KINDS)
def test_specs_hold_the_programs_initial_scales(cfg):
    """Drawn leaf by leaf in the specs' order from the generator the
    program's initialiser takes, every leaf equals the program's bit for bit."""
    port = init_diffusion(serve.diffusion_config(cfg), torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(0)
    for path, shape, init, scale in model_specs(cfg):
        leaf = port
        for k in path.split("/"):
            leaf = leaf[k]
        if init == "normal":
            want = torch.randn(shape, generator=gen).mul_(scale)
        else:
            want = torch.full(shape, 1.0 if init == "ones" else 0.0)
        assert torch.equal(leaf, want), path


@pytest.mark.parametrize("cfg", TINY, ids=KINDS)
def test_reference_alone_equals_the_program_batched(cfg):
    """Four requests of three sizes, submitted two ticks apart so that they
    batch at different steps, served by the engine; each against the
    reference alone."""
    t = tiny_traffic(steps=6)
    engine = serve.build_engine(cfg, t, 11, "cpu")
    res = [(32, 32), (16, 16), (24, 24), (32, 32)]
    arr = [tm.Arrival(i, 0.0, r, 1e9, "window") for i, r in enumerate(res)]
    ins = inputs.request_inputs(cfg, res, 11, "cpu")
    reqs = [serve.make_request(a, 0.0, t["steps"], ins[i]) for i, a in enumerate(arr)]
    n = 0
    while n < len(reqs) or engine.has_work:
        if n < len(reqs):
            engine.submit(reqs[n])
            n += 1
        engine.tick(0.0)
        engine.tick(0.0)
    assert all(r.state == "done" for r in reqs)
    W = inputs.model_weights(cfg, 11, "cpu")
    vae = inputs.vae_weights(cfg, 11, "cpu")
    for i, r in enumerate(reqs):
        z = ref.sample(cfg, W, ins[i]["latent"], inputs.conditioning(ins[i]), t["steps"])
        assert float((r.latent - z).abs().max() / z.abs().max()) < 1e-5
        img = ref.vae_decode(vae, r.latent)
        np.testing.assert_allclose(engine.outputs[i], img.numpy(), atol=1e-4, rtol=0)


def test_tf32_rounding():
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 1.5 * ulp, 1 + 0.49 * ulp, -(1 + 0.51 * ulp),
                      3.0, 1 + ulp])
    want = torch.tensor([1.0, 1.0, 1 + 2 * ulp, 1.0, -(1 + ulp), 3.0, 1 + ulp])
    assert torch.equal(ref.to_tf32(x), want)
    assert torch.equal(ref.to_tf32(one), one)
