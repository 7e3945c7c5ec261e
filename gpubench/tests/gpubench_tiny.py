"""The model kinds found in the tree, tiny configurations (each kind's
``TINY``) and cells for the benchmark's CPU tests."""
from pathlib import Path

from gpubench.reference import kind
# both are imported from here by the tests of the harness and of the engine's spans
from gpubench.reference.dit import TINY as TINY_DIT  # noqa: F401
from gpubench.reference.unet import TINY as TINY_UNET

HERE = Path(__file__).resolve().parents[1]
# a kind is a name with both gpubench/reference/<kind>.py and gpubench/work/<kind>.py
KINDS = sorted(p.stem for p in (HERE / "reference").glob("*.py")
               if not p.stem.startswith("_") and (HERE / "work" / p.name).is_file())
# each kind's tiny configuration, in the order of KINDS: a kind brings its own cases
KIND_TINY = [kind({"kind": k}).TINY for k in KINDS]


def tiny_traffic(**kw) -> dict:
    t = dict(resolutions=[[16, 16], [24, 24], [32, 32]], mix=[1, 1, 1], rate=2.0, arrival_seed=0,
             slo_scale=5,
             base_s={"16x16": 1.0, "24x24": 1.0, "32x32": 1.0}, lead_in_s=1.0, steps=5,
             engine=dict(use_cache=False, policy="slo", max_batch_requests=12,
                         max_batch_patches=4096),
             check=dict(per_resolution=2, limits=dict(latent_err=1e-5, decode_err=1e-4)))
    t.update(kw)
    return t


def tiny_entry(cfg=TINY_UNET, **kw) -> dict:
    units = {"setup_s": "s", "slo_attainment": "%", "slo_ratio_p90": "ratio", "goodput": "req/s"}
    return dict(name=cfg["name"], chips=1, cfg=dict(cfg), traffic=tiny_traffic(**kw),
                end_to_end=[dict(name=n, unit=u) for n, u in units.items()],
                per_layer=[dict(name=n, unit="%") for n in
                           ("engine_step_ms", "step_pred_err", "mfu", "wasted_step_share")])
