"""Benchmark of the PyTorch and CUDA port of PatchedServe (repro_torch)."""
