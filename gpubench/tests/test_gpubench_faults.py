"""A run's ``correct`` on the CPU at a tiny cell: true as the program is, and
false with the timed path broken underneath, once for each fault a serving
cell on one chip can have; and the control (the reference in TF32 in the
program's place) failing the limits of every cell."""
import json
import time
from pathlib import Path

import pytest
import torch

from gpubench import cell, check, manifest, traffic as tm
from gpubench_tiny import KIND_TINY, KINDS, TINY_UNET, tiny_entry
from repro_torch.core import serving
from repro_torch.models import sampler, vae

HERE = Path(__file__).resolve().parents[1]


def run(entry, seed=2 ** 31 + 9):
    return cell.run_cell(entry, seed, 1.5, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cfg", KIND_TINY, ids=KINDS)
def test_a_sound_run_is_correct(cfg):
    r = run(tiny_entry(cfg))
    assert r["correct"], r["checks"]
    assert r["attempted"] == 3 and r["failed"] == 0
    assert list(r)[-1] == "checks"


def _unchanged(cfg, params, csp, patches, *a, **kw):
    return patches


def _half_left_out(step):
    def broken(cfg, params, csp, patches, *a, **kw):
        out = step(cfg, params, csp, patches, *a, **kw)
        keep = torch.as_tensor(csp.patch_req >= csp.n_requests // 2)[:, None, None, None]
        return torch.where(keep, patches, out)
    return broken


def _altered_latent(merge):
    def broken(csp, patches):
        out = merge(csp, patches)
        rid = int(csp.req_ids[0])
        out[rid] = out[rid] * (1 + 1e-3)
        return out
    return broken


def _altered_image(decode):
    def broken(params, latent):
        img = decode(params, latent).clone()
        img[0, 0, 0, 0] += 1e-2
        return img
    return broken


FAULTS = {
    "step returns its state unchanged": (sampler, "sampler_step", lambda f: _unchanged),
    "half of the batch left out": (sampler, "sampler_step", _half_left_out),
    "a latent altered where it is produced": (serving, "merge_by_request", _altered_latent),
    "an image altered where it is produced": (vae, "vae_decode", _altered_image),
}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    mod, name, make = FAULTS[fault]
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    r = run(tiny_entry(TINY_UNET))
    assert not r["correct"], r["checks"]


def cell_limits(kind: str) -> dict:
    """{cell: limits} of every cell whose configuration is of ``kind``."""
    out = {}
    for w in manifest.load()["workloads"]:
        c = manifest.cell(w["name"])
        if c["cfg"]["kind"] == kind:
            out[w["name"]] = c["traffic"]["check"]["limits"]
    return out


@pytest.mark.parametrize("cfg", KIND_TINY, ids=KINDS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_the_limits_of_every_cell_of_its_kind(cfg, seed):
    """The reference in TF32 put in the program's place, on the requests a
    run of a tiny cell would check, reads above the limits of each cell of
    the same model kind."""
    t = tiny_entry(cfg)["traffic"]
    arrivals = tm.schedule(t, 1.5)
    fake = [type("S", (), {"arrival": a, "done": 1.0}) for a in arrivals]
    picks = check.draw_sample(type("R", (), {"seed": seed, "served": fake}), 2)
    got = check.reference_readings(cfg, t, seed, arrivals, [s.arrival.index for s in picks], {},
                                   "cpu", tf32=True)
    for name, limits in cell_limits(cfg["kind"]).items():
        assert got["latent_err"] > limits["latent_err"] or got["decode_err"] > limits["decode_err"], name


@pytest.mark.cuda
def test_control_on_the_card_at_a_public_width(cuda_device):
    """On the card: the SD 1.5-shaped UNet at 512 px, one request, 20 steps:
    the control reads above the sd15 cells' latent_err limits."""
    cfg = json.loads((HERE / "configs" / "sd15-shaped.json").read_text())
    t = json.loads((HERE / "traffic" / "sd15-512-steady.json").read_text())
    arr = [tm.Arrival(0, 0.0, (64, 64), 1e9, "window")]
    got = check.reference_readings(cfg, t, 5, arr, [0], {}, cuda_device, tf32=True)
    assert got["latent_err"] > max(v["latent_err"] for v in cell_limits("unet").values())
