"""Runnable entry points of the port, the counterparts of the reference's
``examples/*.py`` and ``scripts/calibrate_cache_hit_model.py``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_hybrid_resolution --device cpu
    PYTHONPATH=src python -m repro_torch.examples.slo_scheduler_demo --device cpu
    PYTHONPATH=src python -m repro_torch.examples.train_small_lm --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_cluster --device cpu
    PYTHONPATH=src python -m repro_torch.examples.calibrate_cache_hit_model --device cpu

Without ``--device`` each runs on the CUDA card and raises if there is none.
Importing a module does no work: each runs from ``main(argv=None)``.
"""
