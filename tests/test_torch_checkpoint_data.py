"""Port parity: checkpointing and the token pipeline. The six cases of
``tests/test_checkpoint_data.py`` on the port (round trip, atomic rename,
async saves with keep-N, dtype conform on load, pipeline resume, training
resume equal to straight training); checkpoint files written by either
package load into the other bit for bit, bf16 leaves (stored as 2-byte void)
included; the port's ``TokenPipeline`` draws the reference's batches."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.data.pipeline import synthetic_stream as jsynthetic_stream  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.checkpoint.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import TokenPipeline, synthetic_stream  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import opt_init  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)}}


def _mixed():
    """One leaf of each dtype a train state holds."""
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(3, 5, generator=g).bfloat16(),
                       "n": torch.randn(7, generator=g)},
            "opt": {"m": torch.randn(3, 5, generator=g), "step": torch.tensor(3, dtype=torch.int32)}}


def test_save_load_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 7, t)
    step, back = load_checkpoint(tmp_path)
    assert step == 7
    assert torch.equal(back["a"], t["a"]) and torch.equal(back["b"]["c"], t["b"]["c"])


def test_atomicity_no_tmp_left(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    assert not list(Path(tmp_path).glob(".tmp*"))


def test_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_mode=True)
    for s in (10, 20, 30):
        mgr.save(s, _tree())
    mgr.wait()
    assert latest_step(tmp_path) == 30
    steps = sorted(int(p.stem.split("-")[1])
                   for p in Path(tmp_path).glob("ckpt-*.npz"))
    assert steps == [20, 30]
    step, _ = mgr.restore()
    assert step == 30


def test_async_save_snapshots_at_call(tmp_path):
    """The tree is copied to host memory before the save's thread starts: a
    later in-place write does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path, keep=2, async_mode=True)
    t = _tree()
    mgr.save(1, t)
    t["a"].add_(100.0)
    mgr.wait()
    _, back = load_checkpoint(tmp_path)
    assert torch.equal(back["a"], torch.arange(6.0).reshape(2, 3))


def test_load_conforms_dtypes(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.ones((2, 2), dtype=torch.float32)})
    target = {"w": torch.zeros((2, 2), dtype=torch.bfloat16)}
    _, back = load_checkpoint(tmp_path, target=target)
    assert back["w"].dtype == torch.bfloat16 and back["w"].device == target["w"].device


def test_pipeline_determinism_and_resume():
    p1 = TokenPipeline(vocab=101, batch=2, seq=8, seed=3)
    a = [next(p1) for _ in range(3)]
    p2 = TokenPipeline(vocab=101, batch=2, seq=8, seed=3)
    p2.restore({"step": 2})
    b = next(p2)
    np.testing.assert_array_equal(a[2]["tokens"], b["tokens"])
    np.testing.assert_array_equal(b["tokens"], b["labels"])
    assert b["tokens"].max() < 101


def _train(steps, params, opt, pipe, step_fn):
    for _ in range(steps):
        params, opt, m = step_fn(params, opt, next(pipe))
    return params, opt, m


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x7b"])
def test_training_resume_equivalence(tmp_path, arch):
    """Train 4 steps straight == train 2, checkpoint, restore, train 2: the
    loss, every param and every optimizer leaf bit for bit."""
    cfg = ARCHS[arch].reduced()
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = opt_init(cfg, params)
    step_fn = make_train_step(cfg, device="cpu")
    p1, o1, m1 = _train(4, params, opt, TokenPipeline(cfg.vocab_size, 2, 16, seed=0), step_fn)

    pipe2 = TokenPipeline(cfg.vocab_size, 2, 16, seed=0)
    p2, o2, _ = _train(2, params, opt, pipe2, step_fn)
    save_checkpoint(tmp_path, 2, {"params": p2, "opt": o2})
    _, state = load_checkpoint(tmp_path, target={"params": params, "opt": opt})
    pipe3 = TokenPipeline(cfg.vocab_size, 2, 16, seed=0)
    pipe3.restore({"step": 2})
    p2, o2, m2 = _train(2, state["params"], state["opt"], pipe3, step_fn)
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(tree_leaves({"p": p1, "o": o1}), tree_leaves({"p": p2, "o": o2})):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_reference_checkpoint_loads_into_port(tmp_path):
    """A checkpoint written by ``repro.checkpoint`` (bf16 leaves go through
    ``np.savez`` as raw 2-byte void) loads into the port bit for bit."""
    t = _mixed()
    jt = {"params": {"w": jnp.asarray(t["params"]["w"].float().numpy(), jnp.bfloat16),
                     "n": jnp.asarray(t["params"]["n"].numpy())},
          "opt": {"m": jnp.asarray(t["opt"]["m"].numpy()), "step": jnp.asarray(3, jnp.int32)}}
    jckpt.save_checkpoint(tmp_path, 5, jt)
    step, back = load_checkpoint(tmp_path)
    assert step == 5
    assert back["params"]["w"].dtype == torch.bfloat16
    for k in ("params/w", "params/n", "opt/m", "opt/step"):
        a, b = k.split("/")
        assert back[a][b].dtype == t[a][b].dtype and torch.equal(back[a][b], t[a][b]), k
    _, conformed = load_checkpoint(tmp_path, target=t)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(conformed), tree_leaves(t)))


def test_port_checkpoint_loads_into_reference(tmp_path):
    """A checkpoint written by the port loads into ``repro.checkpoint`` bit
    for bit: a bf16 leaf arrives as the same 2-byte void the reference's own
    bf16 saves give, every other leaf in its dtype."""
    t = _mixed()
    save_checkpoint(tmp_path, 9, t, extra={"note": "port"})
    step, back = jckpt.load_checkpoint(tmp_path)
    assert step == 9
    w = back["params"]["w"]
    assert w.dtype == np.dtype("V2")
    np.testing.assert_array_equal(w.view(np.int16), t["params"]["w"].view(torch.int16).numpy())
    ref = Path(tmp_path) / "ref"
    jckpt.save_checkpoint(ref, 9, {"w": jnp.asarray(t["params"]["w"].float().numpy(),
                                                     jnp.bfloat16)})
    _, own = jckpt.load_checkpoint(ref)
    assert own["w"].dtype == w.dtype and own["w"].tobytes() == w.tobytes()
    for a, b in (("params", "n"), ("opt", "m"), ("opt", "step")):
        assert back[a][b].dtype == t[a][b].numpy().dtype
        np.testing.assert_array_equal(back[a][b], t[a][b].numpy())
    assert jckpt.checkpoint.latest_step(tmp_path) == latest_step(tmp_path) == 9


@pytest.mark.parametrize("seed,vocab,batch,seq", [(0, 92544, 2, 64), (3, 101, 4, 8),
                                                  (7, 32000, 1, 33)])
def test_pipeline_equals_reference(seed, vocab, batch, seq):
    tp, jp = TokenPipeline(vocab, batch, seq, seed=seed), JTokenPipeline(vocab, batch, seq,
                                                                          seed=seed)
    for _ in range(4):
        a, b = next(tp), next(jp)
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    assert tp.state() == jp.state() == {"step": 4}
    np.testing.assert_array_equal(synthetic_stream(vocab, seed)(9, 50),
                                  jsynthetic_stream(vocab, seed)(9, 50))


def test_memmap_pipeline_equals_reference(tmp_path):
    """The file-backed source (a flat int32 .bin, wrapping around)."""
    path = Path(tmp_path) / "tokens.bin"
    np.random.default_rng(1).integers(0, 1000, size=203).astype(np.int32).tofile(path)
    tp = TokenPipeline(97, 2, 16, source=str(path))
    jp = JTokenPipeline(97, 2, 16, source=str(path))
    tp.restore({"step": 5})
    jp.restore({"step": 5})
    for _ in range(9):
        np.testing.assert_array_equal(next(tp)["tokens"], next(jp)["tokens"])
