"""Port parity: the entry points of ``repro_torch.examples`` against the
reference's ``examples/`` and ``scripts/calibrate_cache_hit_model.py`` on
the CPU, with the reference's params carried across by ``convert.py``.

- the quickstart (UNet and DiT, tiny config): the batched step equals the
  reference's ``sampler_step`` + ``merge`` at atol=rtol=1e-4, and batched
  against each request alone stays under 1e-4 (the reference's assert);
- ``slo_scheduler_demo.rows`` at qps 8 and 24 for 10 s equals, number for
  number, the rows built from the reference's ``benchmarks.common``
  ``sim_engine`` / ``workload``;
- ``train_small_lm``: 4 steps from the reference's reduced internlm2-1.8b
  params equal the reference's jitted steps (each loss at 1e-4 relative),
  and ``main`` checkpoints and restores step 4;
- the cache-hit calibration writes ``--out`` and never the checked-in data;
- ``serve_hybrid_resolution`` and ``launch.serve`` on the CPU at a cut:
  completed + dropped = submitted, and the image is finite;
- every entry point raises without CUDA when ``--device`` is not given."""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import sim_engine as j_sim_engine  # noqa: E402
from benchmarks.common import workload as j_workload  # noqa: E402
from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core.patching import merge as jmerge  # noqa: E402
from repro.core.patching import split as jsplit  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import diffusion as jdm  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.sampler import sampler_step as jsampler_step  # noqa: E402
from repro.optim import opt_init as j_opt_init  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import diffusion_params_from_numpy, lm_params_from_numpy  # noqa: E402
from repro_torch.examples import calibrate_cache_hit_model as tcal  # noqa: E402
from repro_torch.examples import quickstart as tqs  # noqa: E402
from repro_torch.examples import serve_hybrid_resolution as thybrid  # noqa: E402
from repro_torch.examples import slo_scheduler_demo as tdemo  # noqa: E402
from repro_torch.examples import train_small_lm as ttrain  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
ENTRY_POINTS = ("repro_torch.examples.quickstart",
                "repro_torch.examples.serve_hybrid_resolution",
                "repro_torch.examples.slo_scheduler_demo",
                "repro_torch.examples.train_small_lm",
                "repro_torch.examples.serve_cluster",
                "repro_torch.examples.calibrate_cache_hit_model",
                "repro_torch.launch.serve")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reference_quickstart(kind):
    """examples/quickstart.py, the model kind as a parameter: the params and
    the batched output per request."""
    cfg = jdm.DiffusionConfig(kind=kind, width=32, levels=2, blocks_per_level=1,
                              n_heads=2, groups=4, d_text=16, n_text=4, use_kernels=False)
    params = jdm.init_diffusion(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    latents = [jnp.asarray(rng.normal(size=(h, w, 4)), jnp.float32)
               for h, w in [(16, 16), (24, 24), (32, 32)]]
    text = jnp.asarray(rng.normal(size=(3, cfg.n_text, cfg.d_text)), jnp.float32)
    steps = jnp.asarray([0, 10, 30])
    csp, patches = jsplit(latents, patch=8)
    batched = jmerge(csp, jsampler_step(cfg, params, csp, patches, steps, 50, text))
    return params, [np.asarray(b) for b in batched]


@pytest.mark.parametrize("kind", ["unet", "dit"])
def test_quickstart_matches_reference(kind):
    jparams, want = _reference_quickstart(kind)
    out = tqs.run(kind, device="cpu", params=diffusion_params_from_numpy(_np_tree(jparams),
                                                                          device="cpu"))
    assert out["csp"].total == 29 and out["csp"].patch == 8
    for got, w in zip(out["batched"], want):
        np.testing.assert_allclose(got.numpy(), w, **TOL)
    assert [r["step"] for r in out["rows"]] == [0, 10, 30]
    for r in out["rows"]:
        assert r["max_abs_err"] < 1e-4 and r["psnr"] > 80, r
    tqs.check(out["rows"], full=False)


@pytest.mark.parametrize("kind", ["unet", "dit"])
def test_quickstart_takes_sides_in_any_order(kind):
    """Two requests at one side after a larger one: the CSP sorts them by
    side, and steps and text follow it, so each batched request stays
    within 1e-4 of its step alone (the reference's own quickstart, given
    these sides, is off by up to 0.65)."""
    sides = [(24, 24), (16, 16), (16, 16)]
    out = tqs.run(kind, device="cpu", sides=sides)
    assert [r["resolution"] for r in out["rows"]] == sides
    assert [r["step"] for r in out["rows"]] == [0, 10, 30]
    tqs.check(out["rows"], full=False)


def test_quickstart_main_prints_the_reference_lines(capsys):
    tqs.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("tiny unet: CSP: 29 patches of 8x8, 3 resolution groups")
    for i, res in enumerate(["(16, 16)", "(24, 24)", "(32, 32)"]):
        m = re.match(rf"request {i} {re.escape(res)} at step \d+: max \|batched - solo\| = "
                     r"(\S+), PSNR = ", lines[1 + i])
        assert m and float(m.group(1)) < 1e-4, lines[1 + i]
    assert lines[-1].endswith("quickstart OK")


def test_quickstart_bars():
    """Full width holds step 0 to the PSNR bar only; the tiny config holds
    every request to the error bar."""
    rows = [{"request": 0, "step": 0, "max_abs_err": 5e-4, "psnr": 120.0},
            {"request": 1, "step": 10, "max_abs_err": 2e-6, "psnr": 130.0}]
    tqs.check(rows, full=True)
    with pytest.raises(AssertionError, match="request 0"):
        tqs.check(rows, full=False)
    with pytest.raises(AssertionError, match="PSNR"):
        tqs.check([dict(rows[1], psnr=70.0)], full=True)
    with pytest.raises(AssertionError, match="request 1 at step 10"):
        tqs.check([dict(rows[1], max_abs_err=2e-4)], full=True)


def test_slo_scheduler_demo_rows_match_reference():
    want = []
    for qps in (8.0, 24.0):
        row = [qps]
        for _, kw in tdemo.ARMS:
            eng = j_sim_engine(**kw)
            row.append(eng.run(j_workload(eng, qps, duration=10.0, seed=1)).slo_satisfaction)
        want.append(tuple(row))
    got = tdemo.rows([8.0, 24.0], 10.0, device="cpu")
    assert got == want
    assert got[1][1] > got[1][3]        # SLO-aware mixed batching beats the baseline


def test_train_small_lm_matches_reference_steps(tmp_path):
    """examples/train_small_lm.py's loop, 4 steps, against the port's."""
    jcfg = JARCHS["internlm2-1.8b"].reduced()
    jparams, _ = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_numpy(_np_tree(jparams), "cpu")
    opt = j_opt_init(jcfg, jparams)
    pipe = JTokenPipeline(jcfg.vocab_size, batch=4, seq=64)
    step_fn = jax.jit(j_make_train_step(jcfg))
    ckpt = JCheckpointManager(tmp_path / "jax", keep=2)
    want, params = [], jparams
    for i in range(4):
        params, opt, metrics = step_fn(params, opt, {k: jnp.asarray(v)
                                                     for k, v in next(pipe).items()})
        want.append(float(metrics["loss"]))
    ckpt.save(4, {"params": params, "opt": opt})
    ckpt.wait()
    got = ttrain.train(ARCHS["internlm2-1.8b"].reduced(), tparams, 4, str(tmp_path / "torch"),
                       device="cpu")
    assert got["restored_step"] == ckpt.restore()[0] == 4
    for g, w in zip(got["losses"], want):
        assert abs(g - w) <= 1e-4 * abs(w), (got["losses"], want)
    assert want[-1] < want[0]


def test_train_small_lm_main_restores_step_4(tmp_path, capsys):
    out = ttrain.main(["--device", "cpu", "--steps", "4", "--ckpt", str(tmp_path)])
    assert out["restored_step"] == 4 and len(out["losses"]) == 4
    assert out["losses"][-1] < out["losses"][0]
    assert "checkpoint at step 4 restored OK" in capsys.readouterr().out


def test_calibration_main_writes_out_not_the_checked_in_data(tmp_path, monkeypatch):
    checked_in = ROOT / "benchmarks" / "data" / "cache_calibration.json"
    before = checked_in.read_bytes()
    monkeypatch.setattr(tcal, "COMBOS", tcal.COMBOS[:1])
    out = tcal.main(["--device", "cpu", "--out", str(tmp_path / "cal.json")])
    assert (tmp_path / "cal.json").exists() and checked_in.read_bytes() == before
    assert out["meta"]["n_samples"] == tcal.STEPS == len(out["samples"])
    assert out["meta"]["combos"] == [[3, 0, 0]]
    assert out["fit"]["b_conc"] >= 0 and out["fit"]["b_step"] >= 0
    assert tcal.BUILD == ROOT / "build"


def test_serve_hybrid_resolution_on_cpu(tmp_path):
    path = tmp_path / "img.npy"
    out = thybrid.main(["--device", "cpu", "--duration", "2", "--out", str(path)])
    m, wl = out["metrics"], out["workload"]
    assert wl and m.completed >= 1 and m.completed + m.dropped == len(wl)
    img = np.load(path)
    h, w = next(r.resolution for r in wl if r.rid == next(iter(out["engine"].outputs)))
    assert img.shape == (8 * h, 8 * w, 3) and np.all(np.isfinite(img))
    assert np.array_equal(img, out["image"])


def test_serve_launcher_real_clock_with_cache_on_cpu(capsys):
    m = tserve.main(["--device", "cpu", "--cache", "--duration", "2"])
    printed = capsys.readouterr().out
    submitted = int(re.search(r"requests=(\d+)", printed).group(1))
    assert submitted >= 1 and m.completed >= 1 and m.completed + m.dropped == submitted
    assert all(np.isfinite(m.step_latencies))


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_point_needs_cuda_without_device(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    main = importlib.import_module(module).main
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main([])
