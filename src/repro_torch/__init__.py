"""PatchedServe on PyTorch and CUDA (NVIDIA H100).

A port of ``src/repro`` (the JAX reference) that imports neither ``jax`` nor
``repro``. Public functions keep the reference's layouts: patches are
``(P, p, p, C)`` NHWC, attention tensors ``(B, S, H, D)``, conv weights HWIO.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
