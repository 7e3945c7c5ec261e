"""The model kind is a plug-in: ``reference/<kind>.py`` beside ``work/<kind>.py``.

The draws of the kinds that exist are pinned by digests taken on the commit
before the kinds became plug-ins (float32 on an x86-64 CPU; the same with 1,
2 or 4 threads): the parameter rows, the weights, the request inputs, the
reference's final latent and the control's readings, bit for bit. Every
kind found in the tree gives the contract's names; a kind that no file
defines fails before any weight is drawn; a kind injected under a new name,
with a second conditioning row, reaches every place that draws, submits or
samples; and no other harness module knows a kind's name."""
import ast
import hashlib
import importlib
import importlib.machinery
import json
import sys
import types
from pathlib import Path

import pytest
import torch

from gpubench import check, inputs, manifest, serve, traffic as tm
from gpubench.reference import diffusion as ref, kind
from gpubench.reference.params import model_specs
from gpubench_tiny import KINDS, TINY_DIT, TINY_UNET, tiny_traffic

HERE = Path(__file__).resolve().parents[1]
RES = [(16, 16), (24, 24), (32, 32), (16, 16)]

SPECS = {
    "pixart-alpha-shaped": "3429ee586becdc03638ad60842fbfd73c5940a1dab9ad7fe0efb5b3a2abc393d",
    "sd15-shaped": "4dbfcb3c52156aaa279687b4cc5daa27b4cf5d26957307e510272b91011692db",
    "tiny-unet": "f417ad4a8eebcf15999930d13911028e8712eb0acbdafae9b6e4cb3016f5ec13",
    "tiny-dit": "13bfaa8a2791f038c5820ccd4966760ab02fa528828211f60f9f81e8ed167d1e",
}
# {(tiny configuration, seed): (model weights, VAE weights, request inputs at RES)}
DRAWS = {
    ("tiny-unet", 0): ("9eedf740ee6f948ce686b3d7de795e7991ad83676065a3732c882e78026fe4ec",
                       "995b2ed860e82ee37fa595e265241ea6aa5063e3f726701c96ac5cf18f39a697",
                       "7fc1d471f8dd79e302495e53418d19788deb8754c64330cbd958f35c79126044"),
    ("tiny-unet", 5): ("0ff507447b4b05b61b0ce6cc1c4f822a023760866c65de2defc2e053ab47610d",
                       "ee54ea3e591c0fa1348c5646b99e2b9d2591848a4928740067254200136fbc20",
                       "90e9394c83d10d261c2870fbb8ae4dd45d6a5df31d164e95b84d616d6aab387a"),
    ("tiny-dit", 0): ("96fd8e75b32e27dc1b956f411f8015c8fa003cbda50006a290b33890e319ea93",
                      "995b2ed860e82ee37fa595e265241ea6aa5063e3f726701c96ac5cf18f39a697",
                      "4cadfb312a0339aa705f819ad1d81218632bb5a2649e7d4f55900fbe70350313"),
    ("tiny-dit", 5): ("9c8917fdb2433f312b729e2c849c33bde4bff4a2815ff58d068f61ac4f2f1f58",
                      "ee54ea3e591c0fa1348c5646b99e2b9d2591848a4928740067254200136fbc20",
                      "a7acbd83d1054d75d4efa83a0dd85ef40c836e38dccd3eeb6ebad698870fbeda"),
}
# the reference's final latent of request 1 (24 x 24), seed 0, 5 steps
SAMPLE = {"tiny-unet": "6df3c8742d4da974890a7fdf85f216f9b3c17c9f1232a845ef92fec15c491a3d",
          "tiny-dit": "d66ffbc93acfcf3d9f448d3e4363b9122ac5dfba4c06f4238a325d03665f335a"}
TINY = {c["name"]: c for c in (TINY_UNET, TINY_DIT)}


def rows_digest(rows) -> str:
    return hashlib.sha256(json.dumps([[p, list(s), i, sc] for p, s, i, sc in rows])
                          .encode()).hexdigest()


def tree_digest(tree) -> str:
    h = hashlib.sha256()

    def walk(t, prefix):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], f"{prefix}{k}/")
            else:
                h.update(f"{prefix}{k}".encode())
                h.update(t[k].contiguous().numpy().tobytes())
    walk(tree, "")
    return h.hexdigest()


def inputs_digest(reqs) -> str:
    h = hashlib.sha256()
    for r in reqs:
        for k, v in r.items():
            h.update(k.encode())
            h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", SPECS)
def test_parameter_rows_are_the_parents(name):
    path = HERE / "configs" / f"{name}.json"
    cfg = json.loads(path.read_text()) if path.is_file() else TINY[name]
    assert rows_digest(model_specs(cfg)) == SPECS[name]


@pytest.mark.parametrize("name,seed", DRAWS, ids=[f"{n}-{s}" for n, s in DRAWS])
def test_weights_and_request_inputs_are_the_parents(name, seed):
    cfg = TINY[name]
    got = (tree_digest(inputs.model_weights(cfg, seed, "cpu")),
           tree_digest(inputs.vae_weights(cfg, seed, "cpu")),
           inputs_digest(inputs.request_inputs(cfg, RES, seed, "cpu")))
    assert got == DRAWS[name, seed]


@pytest.mark.parametrize("name", SAMPLE)
def test_reference_latents_are_the_parents(name):
    cfg = TINY[name]
    ins = inputs.request_inputs(cfg, RES, 0, "cpu")[1]
    z = ref.sample(cfg, inputs.model_weights(cfg, 0, "cpu"), ins["latent"],
                   inputs.conditioning(ins), 5)
    assert hashlib.sha256(z.contiguous().numpy().tobytes()).hexdigest() == SAMPLE[name]


def test_control_readings_are_the_parents():
    t = tiny_traffic()
    arr = tm.schedule(t, 1.5)
    fake = [type("S", (), {"arrival": a, "done": 1.0}) for a in arr]
    picks = [s.arrival.index for s in check.draw_sample(type("R", (), {"seed": 3, "served": fake}), 2)]
    assert picks == [2, 3, 4]
    got = check.reference_readings(TINY_UNET, t, 3, arr, picks, {}, "cpu", tf32=True)
    assert got == {"latent_err": 0.0006406949833035469, "decode_err": 0.0930359959602356}


def test_an_unknown_kind_fails_before_any_weight_is_drawn(monkeypatch):
    """A configuration with the UNet's fields under a kind no file defines:
    the dispatcher's error, naming both files, not UNet weights."""
    cfg = dict(TINY_UNET, kind="no_such_kind")
    where = r"reference/no_such_kind\.py and gpubench/work/no_such_kind\.py"
    monkeypatch.setattr(inputs, "draw_tree", lambda *a, **kw: pytest.fail("weights drawn"))
    for call in (lambda: model_specs(cfg), lambda: inputs.model_weights(cfg, 0, "cpu"),
                 lambda: inputs.request_inputs(cfg, RES, 0, "cpu"),
                 lambda: ref.sample(cfg, {}, torch.zeros(16, 16, 4), {}, 1)):
        with pytest.raises(LookupError, match=where):
            call()
    for name in ("diffusion", "params", "peaks", "patch_attention", "__init__", "../unet"):
        with pytest.raises(LookupError):
            kind({"kind": name})


def test_the_kinds_found_hold_every_configurations_kind():
    configs = [json.loads(p.read_text()) for p in sorted((HERE / "configs").glob("*.json"))]
    assert {"dit", "unet"} <= set(KINDS)
    assert {c["kind"] for c in configs} <= set(KINDS)


@pytest.mark.parametrize("name", KINDS)
def test_each_kind_gives_every_name_of_the_contract(name):
    """Whatever kinds the tree holds: each module gives the kind contract's
    names, and its tiny configuration is of its own kind."""
    mod = kind({"kind": name})
    for attr in ("specs", "conditioning", "sample", "forward", "TINY"):
        assert hasattr(mod, attr), (name, attr)
    assert callable(importlib.import_module(f"gpubench.work.{name}").flops)
    assert mod.TINY["kind"] == name


def _module(name: str, **attrs) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
    mod.__dict__.update(attrs)
    return mod


def test_a_kind_injected_under_a_new_name_reaches_every_draw_and_call(monkeypatch):
    """A kind with the DiT's rows and a second conditioning row, ``pooled``,
    given as two modules and no edit: its rows are drawn, its conditioning
    comes after the latents in its rows' order, each tensor reaches the
    program's ``Request`` as a keyword and the reference's ``sample`` by name,
    and ``mfu`` counts its work."""
    from repro_torch.core import requests
    dit = kind(TINY_DIT)
    seen = {}

    def sample(cfg, P, latent, cond, steps, tf32=False):
        seen.update(cond=cond, steps=steps, tf32=tf32)
        return latent

    cfg = dict(TINY_DIT, name="tiny-toy", kind="toy")
    rows = dit.conditioning(cfg) + [("pooled", (7,), 2.0)]
    monkeypatch.setitem(sys.modules, "gpubench.reference.toy", _module(
        "gpubench.reference.toy", specs=dit.specs, conditioning=lambda c: rows, sample=sample,
        TINY=cfg))
    monkeypatch.setitem(sys.modules, "gpubench.work.toy", _module(
        "gpubench.work.toy", flops=lambda c, H, W: 1e12 * H * W))

    assert model_specs(cfg) == model_specs(TINY_DIT)
    ins = inputs.request_inputs(cfg, RES, 5, "cpu")
    want = inputs.request_inputs(TINY_DIT, RES, 5, "cpu")
    assert [list(r) for r in ins] == [["latent", "text", "pooled"]] * len(RES)
    for got, base in zip(ins, want):
        assert torch.equal(got["latent"], base["latent"]) and torch.equal(got["text"], base["text"])
        assert got["pooled"].shape == (7,)
    gen = inputs.generator(5, "requests", "cpu")
    torch.randn(sum(h * w * 4 for h, w in RES), generator=gen)
    torch.randn(len(RES), cfg["n_text"], cfg["d_text"], generator=gen)
    assert torch.equal(torch.stack([r["pooled"] for r in ins]),
                       torch.randn(len(RES), 7, generator=gen).mul_(2.0))

    monkeypatch.setattr(requests, "Request", lambda **kw: kw)
    a = tm.Arrival(1, 0.0, RES[1], 9.0, "window")
    kw = serve.make_request(a, 2.0, 20, ins[1])
    assert kw["text"] is ins[1]["text"] and kw["pooled"] is ins[1]["pooled"]
    assert torch.equal(kw["latent"], ins[1]["latent"]) and kw["latent"] is not ins[1]["latent"]

    z = ref.sample(cfg, {}, ins[1]["latent"], inputs.conditioning(ins[1]), 3, tf32=True)
    assert z is ins[1]["latent"] and set(seen["cond"]) == {"text", "pooled"}
    assert (seen["steps"], seen["tf32"]) == (3, True)

    tick = types.SimpleNamespace(dt=1.0, stepped=[types.SimpleNamespace(arrival=a)])
    run = types.SimpleNamespace(cfg=cfg, window_ticks=[tick])
    assert manifest.reader("mfu").read(run) == pytest.approx(100.0 * 1e12 * 24 * 24 / 989e12)


def _kind_literals(node) -> set:
    """String constants among the operands of every comparison under node."""
    out = set()
    for c in ast.walk(node):
        if isinstance(c, ast.Compare):
            for side in [c.left, *c.comparators]:
                out |= {x.value for x in ast.walk(side)
                        if isinstance(x, ast.Constant) and isinstance(x.value, str)}
    return out


def test_no_harness_module_compares_against_a_kind_name():
    own = {HERE / d / f"{k}.py" for k in KINDS for d in ("reference", "work")}
    for path in sorted(HERE.rglob("*.py")):
        if "tests" in path.parts or path in own:
            continue
        found = _kind_literals(ast.parse(path.read_text())) & set(KINDS)
        assert not found, (str(path.relative_to(HERE)), found)
