"""Diffusion backbones, samplers and the VAE/text stubs."""
