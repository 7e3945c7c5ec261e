"""eval_err of the paper's MLP latency predictor (§6.1) over seeds, in the
JAX reference and in the PyTorch port, on the dataset of
``tests/test_latency_predictor.py`` (200 compositions of the analytic
surrogate with 1% noise). The seed picks both the 80/20 split and the
initial weights; the port cannot reproduce ``jax.random`` draws, so its
last line also fits from the reference's seed-0 weights. On the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/latency_fit_seeds.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import latency_model as jlat  # noqa: E402
from repro_torch.convert import mlp_params_from_numpy  # noqa: E402
from repro_torch.core import latency_model as tlat  # noqa: E402
from test_torch_predictors import _latency_dataset  # noqa: E402


def main() -> None:
    X, y = _latency_dataset()
    print("seed  reference  port")
    for seed in range(6):
        j = jlat.fit_latency_model(X, y, seed=seed).eval_err
        t = tlat.fit_latency_model(X, y, seed=seed, device="cpu").eval_err
        print(f"{seed:4d}  {j:.4f}     {t:.4f}")
    start = jlat._init(jax.random.PRNGKey(0), X.shape[-1])
    start = mlp_params_from_numpy({k: np.asarray(v) for k, v in start.items()}, device="cpu")
    tlat._init = lambda generator, d_in, device=None: start
    t = tlat.fit_latency_model(X, y, device="cpu").eval_err
    print(f"port from the reference's seed-0 weights: {t:.4f}")


if __name__ == "__main__":
    main()
