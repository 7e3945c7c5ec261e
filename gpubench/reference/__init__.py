"""Plain PyTorch reference of the served diffusion path: each request alone,
as a whole image. Imports nothing of the program under test."""
