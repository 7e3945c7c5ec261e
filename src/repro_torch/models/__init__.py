"""Diffusion backbones, samplers, the VAE/text stubs, and the LM family
(configs in ``repro_torch.configs``)."""
