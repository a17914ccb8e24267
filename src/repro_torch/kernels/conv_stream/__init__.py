"""Streaming VALID conv (kernel K6, ``conv_backend="pallas"``): launcher,
public wrapper and the plain PyTorch version of the kernel."""
