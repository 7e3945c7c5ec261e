"""The port's training launcher and fault tolerance on the CPU, and against
the reference's trainer:
``ElasticTrainer`` remesh-and-restore (the counterpart of
``tests/test_distributed.py::test_elastic_remesh_resume``), the straggler
event, ``python -m repro_torch.launch.train --device cpu`` then
``--resume``, the one-device mesh and the ambient mesh context, the rule
that entry points default to the card and raise without one, and that no
module of the port imports JAX or the reference package."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.distributed import elastic  # noqa: E402
from repro_torch.distributed.elastic import ElasticConfig, ElasticTrainer  # noqa: E402
from repro_torch.launch import context as ctx  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import opt_init  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _setup(dtype="float32"):
    cfg = dataclasses.replace(ARCHS["internlm2-1.8b"].reduced(), dtype=dtype)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, opt_init(cfg, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elastic_remesh_resume(tmp_path, dtype):
    """A simulated failure at step 5 shrinks the mesh and restores the
    step-3 checkpoint onto the device in the params' and state's dtypes.
    As in the reference, the schedule fires each time the loop reaches step
    5 again: 10 batches give three remeshes and end at step 4."""
    cfg, params, opt = _setup(dtype)
    pipe = TokenPipeline(cfg.vocab_size, 2, 16)
    ckpt = CheckpointManager(tmp_path, keep=2, async_mode=False)
    meshes = []
    tr = ElasticTrainer(
        make_mesh=lambda n: meshes.append(n) or tmesh.make_local_mesh(),
        build_step=lambda mesh: make_train_step(cfg, device="cpu"),
        ckpt=ckpt, cfg=ElasticConfig(ckpt_every=3), device="cpu")
    batches = [next(pipe) for _ in range(10)]
    dtypes = [t.dtype for t in tree_leaves({"p": params, "o": opt})]
    params, opt, step, metrics = tr.run(params, opt, batches, fail_at={5: 2})
    assert [e for e in tr.events if e["event"] == "remesh"] == [
        {"step": 5, "event": "remesh", "n": 2}] * 3
    assert meshes == [1, 2, 2, 2] and tr.failures == 3
    assert step == 4 and int(opt["step"]) == 4
    assert np.isfinite(float(metrics["loss"]))
    assert [t.dtype for t in tree_leaves({"p": params, "o": opt})] == dtypes


def test_elastic_matches_reference_trainer(tmp_path):
    """The reference's ``ElasticTrainer`` on a one-device mesh and the
    port's, from the same params and batches: the same remesh events, step
    counts and checkpoints, and the final loss at 1e-4."""
    import jax
    from repro.checkpoint import CheckpointManager as JCheckpointManager
    from repro.configs import ARCHS as JARCHS
    from repro.distributed.elastic import ElasticConfig as JElasticConfig
    from repro.distributed.elastic import ElasticTrainer as JElasticTrainer
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.models import lm as jlm
    from repro.optim import opt_init as jopt_init
    from repro_torch.convert import lm_params_from_numpy

    jcfg = JARCHS["internlm2-1.8b"].reduced()
    cfg = ARCHS["internlm2-1.8b"].reduced()
    jp, _ = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    pipe = TokenPipeline(cfg.vocab_size, 2, 16)
    batches = [next(pipe) for _ in range(8)]
    runs = []
    for trainer, params, opt, d in (
            (JElasticTrainer(make_mesh=lambda n: jax.make_mesh((1,), ("data",)),
                             build_step=lambda mesh: jax.jit(jmake_train_step(jcfg)),
                             ckpt=JCheckpointManager(tmp_path / "j", async_mode=False),
                             cfg=JElasticConfig(ckpt_every=2)), jp, jopt_init(jcfg, jp), "j"),
            (ElasticTrainer(make_mesh=lambda n: tmesh.make_local_mesh(),
                            build_step=lambda mesh: make_train_step(cfg, device="cpu"),
                            ckpt=CheckpointManager(tmp_path / "t", async_mode=False),
                            cfg=ElasticConfig(ckpt_every=2), device="cpu"),
             tp, opt_init(cfg, tp), "t")):
        _, _, step, metrics = trainer.run(params, opt, batches, fail_at={5: 1})
        runs.append((step, float(metrics["loss"]),
                     [e for e in trainer.events if e["event"] == "remesh"],
                     sorted(p.name for p in (tmp_path / d).glob("ckpt-*"))))
    (js, jl, je, jf), (ts, tl, te, tf) = runs
    assert (ts, te, tf) == (js, je, jf)
    assert abs(tl - jl) <= 1e-4 * abs(jl)


def test_elastic_straggler_event(tmp_path, monkeypatch):
    """A step slower than straggler_factor x the rolling median is logged.
    The steps advance a fake clock, so the test does not depend on the
    host's load."""
    clock = [0.0]
    monkeypatch.setattr(elastic.time, "perf_counter", lambda: clock[0])
    durations = [0.01] * 6 + [0.05] + [0.01] * 2

    def build_step(mesh):
        def step(params, opt, batch):
            clock[0] += durations[batch]
            return params, opt, {"loss": torch.tensor(0.0)}
        return step

    tr = ElasticTrainer(make_mesh=lambda n: tmesh.make_local_mesh(), build_step=build_step,
                        ckpt=CheckpointManager(tmp_path, async_mode=False),
                        cfg=ElasticConfig(ckpt_every=100), device="cpu")
    _, _, step, _ = tr.run({"w": torch.zeros(2)}, {"step": torch.tensor(0)}, range(9))
    assert step == 9
    assert tr.events == [{"step": 6, "event": "straggler", "dt": pytest.approx(0.05)}]


def test_launcher_train_then_resume(tmp_path, capsys):
    """The reference's command line with ``--device cpu``: 4 steps (with
    checkpoints at 2 and 4), then 2 more from the checkpoint."""
    ck = str(tmp_path / "ck")
    out = ttrain.main(["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
                       "--ckpt", ck])
    assert out["step"] == 4 and np.isfinite(out["loss"])
    first = capsys.readouterr().out
    assert "arch=internlm2-1.8b-smoke steps=4" in first
    again = ttrain.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                         "--ckpt", ck, "--resume"])
    text = capsys.readouterr().out
    assert "resumed from step 4" in text and again["step"] == 6
    assert sorted(p.name for p in Path(ck).glob("ckpt-*.npz")) == [
        "ckpt-000000005.npz", "ckpt-000000006.npz"]


def test_launcher_resume_equals_straight_run(tmp_path):
    """Two launcher runs of 2 steps each (the second with ``--resume``) end
    on the params of one 4-step run."""
    args = ["--device", "cpu", "--batch", "2", "--seq", "16"]
    straight = ttrain.main(args + ["--steps", "4", "--ckpt", str(tmp_path / "a")])
    ttrain.main(args + ["--steps", "2", "--ckpt", str(tmp_path / "b")])
    resumed = ttrain.main(args + ["--steps", "2", "--ckpt", str(tmp_path / "b"), "--resume"])
    assert resumed["step"] == straight["step"] == 4
    assert resumed["loss"] == straight["loss"]
    for a, b in zip(tree_leaves(straight["params"]), tree_leaves(resumed["params"])):
        assert torch.equal(a, b)


def test_meshes_and_context():
    m = tmesh.make_local_mesh()
    assert m.axis_names == ("data", "model") and m.shape == {"data": 1, "model": 1}
    assert tmesh.dp_axes(m) == ("data",)
    assert tmesh.dp_axes(tmesh.Mesh(("pod", "data", "model"), (2, 16, 16))) == ("pod", "data")
    assert tmesh.make_local_mesh(data=4).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        tmesh.make_local_mesh(model=2)
    with pytest.raises(RuntimeError, match="256 devices"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 devices"):
        tmesh.make_production_mesh(multi_pod=True)
    assert ctx.current_mesh() is None
    with ctx.use_mesh(m):
        assert ctx.current_mesh() is m
    assert ctx.current_mesh() is None


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without CUDA, the train step, the trainer and the launcher raise when
    no device is given; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["internlm2-1.8b"].reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ElasticTrainer(make_mesh=lambda n: None, build_step=lambda m: None,
                       ckpt=CheckpointManager(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--steps", "1", "--ckpt", str(tmp_path)])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 50
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, bad
