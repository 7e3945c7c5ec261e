"""Port parity: the paper's two learned predictors and the latency / cache-hit
surrogates (repro_torch.core.{latency_model,cache_predictor} vs repro).

The MLPs start both packages from the same numpy weights
(``mlp_params_from_numpy``) and are compared after N full-batch steps, not
at the end of a whole fit, where fp32 rounding in the two frameworks can
part. The numpy surrogates must be equal exactly."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cache_predictor as jcp  # noqa: E402
from repro.core import latency_model as jlat  # noqa: E402
from repro_torch.convert import mlp_params_from_numpy  # noqa: E402
from repro_torch.core import cache_predictor as tcp  # noqa: E402
from repro_torch.core import latency_model as tlat  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PPR = [4, 9, 16]
RES = [(16, 16), (24, 24), (32, 32)]


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _close_trees(t_tree, j_tree, tol):
    assert set(t_tree) == set(j_tree)
    for k in j_tree:
        np.testing.assert_allclose(t_tree[k].numpy(), np.asarray(j_tree[k]), rtol=tol, atol=tol,
                                   err_msg=k)


def _latency_dataset(n=200, seed=0, noise=0.01):
    """The reference test's dataset (tests/test_latency_predictor.py)."""
    rng = np.random.default_rng(seed)
    feats, lats = [], []
    for _ in range(n):
        counts = rng.integers(0, 5, size=3)
        if counts.sum() == 0:
            counts[rng.integers(3)] = 1
        lat = tlat.analytic_step_latency(counts, PPR)
        lat *= 1 + rng.normal() * noise
        feats.append(tlat.make_features(counts, PPR))
        lats.append(lat)
    return np.stack(feats), np.asarray(lats)


def _delta_dataset(n=512, seed=0):
    rng = np.random.default_rng(seed)
    delta = 10 ** rng.uniform(-6, 0, size=n)
    return delta, (delta < 3e-3).astype(np.float32)


# ---------------- numpy surrogates: exact ----------------

@pytest.mark.parametrize("counts", [[1, 0, 0], [0, 3, 0], [2, 1, 4], [0, 0, 12], [5, 5, 5]])
@pytest.mark.parametrize("patch,hit", [(8, 0.0), (16, 0.4), (32, 1.3)])
def test_patch_aware_step_latency_equals_reference(counts, patch, hit):
    kw = dict(cache_hit_rate=hit)
    assert tlat.patch_aware_step_latency(counts, RES, patch, **kw) == \
        jlat.patch_aware_step_latency(counts, RES, patch, **kw)


def test_cache_hit_model_equals_reference():
    tm, jm = tlat.CacheHitModel(), jlat.CacheHitModel()
    assert (tm.b0, tm.b_conc, tm.b_step) == (jm.b0, jm.b_conc, jm.b_step)
    grid = np.linspace(-0.2, 1.2, 8)
    for conc in grid:
        for frac in grid:
            assert tm.hit_rate(conc, frac) == jm.hit_rate(conc, frac)
            for l1, l2, disc in ((0.0, 0.0, 0.7), (0.3, 0.5, 0.7), (1.0, 0.2, 1.5),
                                 (-0.1, 1.1, 0.4)):
                assert tm.two_level_hit_rate(conc, frac, l1, l2, l2_discount=disc) == \
                    jm.two_level_hit_rate(conc, frac, l1, l2, l2_discount=disc)


def test_fit_cache_hit_model_equals_reference_on_checked_in_samples():
    data = json.loads((ROOT / "benchmarks" / "data" / "cache_calibration.json").read_text())
    samples = [tuple(s) for s in data["samples"]]
    tm, jm = tlat.fit_cache_hit_model(samples), jlat.fit_cache_hit_model(samples)
    assert (tm.b0, tm.b_conc, tm.b_step) == (jm.b0, jm.b_conc, jm.b_step)
    with pytest.raises(ValueError):
        tlat.fit_cache_hit_model(samples[:2])


# ---------------- latency MLP (paper §6.1) ----------------

def _latency_start():
    X, y = _latency_dataset()
    jparams = jlat._init(jax.random.PRNGKey(3), X.shape[-1])
    tparams = mlp_params_from_numpy(_np_tree(jparams), device="cpu")
    mu, sd = X.mean(0), X.std(0) + 1e-8
    x = ((X - mu) / sd).astype(np.float32)
    yn = ((y - y.mean()) / y.std()).astype(np.float32)
    return jparams, tparams, x, yn


def test_latency_mlp_forward_matches_reference():
    jparams, tparams, x, _ = _latency_start()
    want = np.asarray(jlat._fwd(jparams, jnp.asarray(x)))
    got = tlat._fwd(tparams, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_latency_mlp_steps_match_reference():
    """50 full-batch gradient steps from the same numpy weights."""
    jparams, tparams, x, y = _latency_start()
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    for _ in range(50):
        jparams, jloss = jlat._step(jparams, jx, jy, 0.01)
        tparams, tloss = tlat._step(tparams, tx, ty, 0.01)
    _close_trees(tparams, jparams, 1e-5)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-6)


def test_latency_model_init_shapes_and_device_rule():
    p = tlat._init(torch.Generator().manual_seed(0), 5, device="cpu")
    j = jlat._init(jax.random.PRNGKey(0), 5)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in j.items()}
    assert all(v.dtype == torch.float32 for v in p.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tlat._init(torch.Generator().manual_seed(0), 5)
        with pytest.raises(RuntimeError):
            tlat.fit_latency_model(*_latency_dataset(n=10), epochs=1)


def test_fit_latency_model_beats_paper_error_bar(monkeypatch):
    """The port of test_mlp_beats_paper_error_bar: < 3.7% relative error on
    the 20% eval split. The port cannot reproduce ``jax.random`` draws, and
    the bar depends on the initial draw (the reference itself misses it at
    seeds 1, 3, 4 and 5 of this dataset: ``scripts/latency_fit_seeds.py``),
    so the port's fit starts from the reference's seed-0 weights: the same
    split, the same start, the port's own 1,500 steps."""
    X, y = _latency_dataset()
    start = mlp_params_from_numpy(_np_tree(jlat._init(jax.random.PRNGKey(0), X.shape[-1])),
                                  device="cpu")
    monkeypatch.setattr(tlat, "_init", lambda generator, d_in, device=None: start)
    m = tlat.fit_latency_model(X, y, epochs=1500, device="cpu")
    assert m.eval_err < 0.037, m.eval_err


def test_fit_latency_model_is_monotone_in_load():
    """The port of test_predictor_monotone_in_load, from the port's own
    seed-0 draw."""
    X, y = _latency_dataset()
    m = tlat.fit_latency_model(X, y, epochs=1500, device="cpu")
    lo = m.predict(tlat.make_features([1, 0, 0], PPR))
    hi = m.predict(tlat.make_features([4, 4, 4], PPR))
    assert hi > lo
    assert isinstance(lo, float) and np.isfinite(m.eval_err)


def test_latency_model_predict_matches_reference_from_same_weights():
    X, y = _latency_dataset()
    jparams = jlat._init(jax.random.PRNGKey(1), X.shape[-1])
    mu, sd = X.mean(0), X.std(0) + 1e-8
    jm = jlat.LatencyModel(jparams, mu, sd, float(y.mean()), float(y.std()))
    tm = tlat.LatencyModel(mlp_params_from_numpy(_np_tree(jparams), device="cpu"),
                           mu, sd, float(y.mean()), float(y.std()))
    for i in range(0, 200, 17):
        assert tm.predict(X[i]) == pytest.approx(jm.predict(X[i]), rel=1e-6, abs=1e-9)


# ---------------- cache reuse predictor (paper §5.1) ----------------

def test_predictor_features_and_logit_match_reference():
    delta, _ = _delta_dataset(64)
    in_scale = np.linspace(0.1, 3.0, 64)
    jf = jcp.predictor_features(jnp.asarray(delta, jnp.float32), 0.3, 0.7,
                                jnp.asarray(in_scale, jnp.float32))
    tf = tcp.predictor_features(torch.as_tensor(delta, dtype=torch.float32), 0.3, 0.7,
                                torch.as_tensor(in_scale, dtype=torch.float32))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=1e-6)
    jparams = jcp.init_mlp(jax.random.PRNGKey(2))
    tparams = mlp_params_from_numpy(_np_tree(jparams), device="cpu")
    np.testing.assert_allclose(tcp.mlp_logit(tparams, tf).numpy(),
                               np.asarray(jcp.mlp_logit(jparams, jf)), rtol=1e-6, atol=1e-6)


def test_cache_predictor_train_steps_match_reference():
    delta, labels = _delta_dataset()
    feats = np.array(jcp.predictor_features(jnp.asarray(delta, jnp.float32), 0.5, 0.5,
                                              jnp.ones(len(delta), jnp.float32)))
    jparams = jcp.init_mlp(jax.random.PRNGKey(0), d_in=feats.shape[-1])
    tparams = mlp_params_from_numpy(_np_tree(jparams), device="cpu")
    jf, jy = jnp.asarray(feats), jnp.asarray(labels)
    tf, ty = torch.as_tensor(feats), torch.as_tensor(labels)
    for _ in range(50):
        jparams, jloss = jcp._train_step(jparams, jf, jy, 0.05)
        tparams, tloss = tcp._train_step(tparams, tf, ty, 0.05)
    _close_trees(tparams, jparams, 1e-5)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-6)


def test_train_mlp_learns_threshold():
    """The port of test_cache_predictor_learns_threshold."""
    delta, labels = _delta_dataset()
    d = torch.as_tensor(delta)
    feats = tcp.predictor_features(d, 0.5, 0.5, torch.ones_like(d)).numpy()
    params, acc = tcp.train_mlp(feats, labels, epochs=300, device="cpu")
    assert acc > 0.95, acc
    assert set(params) == {"w1", "b1", "w2", "b2"}


def test_mlp_predictor_decisions_match_reference():
    """From converted weights, the same reuse decisions on the same deltas,
    and ``at`` carries the weights and scale to a new step/block."""
    delta, labels = _delta_dataset()
    feats = np.array(jcp.predictor_features(jnp.asarray(delta, jnp.float32), 0.5, 0.5,
                                              jnp.ones(len(delta), jnp.float32)))
    jparams, _ = jcp.train_mlp(feats, labels, epochs=300)
    tparams = mlp_params_from_numpy(_np_tree(jparams), device="cpu")
    for step_frac, block_frac in ((0.5, 0.5), (0.1, 0.9)):
        jp = jcp.MLPPredictor(jparams, in_scale=1.5).at(step_frac, block_frac)
        tp = tcp.MLPPredictor(tparams, in_scale=1.5).at(step_frac, block_frac)
        assert (tp.step_frac, tp.block_frac, tp.in_scale) == (step_frac, block_frac, 1.5)
        want = np.asarray(jp(jnp.asarray(delta, jnp.float32)))
        got = tp(torch.as_tensor(delta, dtype=torch.float32))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
