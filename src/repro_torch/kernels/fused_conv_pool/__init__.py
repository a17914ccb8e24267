"""Fused conv + bias + ReLU + max-pool (kernel K5,
``pool_backend="fused"``): launcher, public wrapper and the plain PyTorch
version of the kernel."""
