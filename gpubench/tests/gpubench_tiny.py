"""Tiny configurations and cells for the benchmark's CPU tests."""

TINY_UNET = dict(name="tiny-unet", kind="unet", latent_channels=4, width=16, levels=2,
                 blocks_per_level=1, attn_levels=[0, 1], n_heads=2, groups=4, d_text=8, n_text=4,
                 t_dim=16, exact_stats=True, use_kernels=True, dtype="float32", vae_width=8,
                 precision="float32, TF32 off")
TINY_DIT = dict(name="tiny-dit", kind="dit", latent_channels=4, width=24, dit_depth=2, n_heads=3,
                groups=4, d_text=12, n_text=5, t_dim=16, exact_stats=True, use_kernels=True,
                dtype="float32", vae_width=8, precision="float32, TF32 off")


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
