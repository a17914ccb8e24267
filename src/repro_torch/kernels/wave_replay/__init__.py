"""Per-layer wave-replay megakernel (fp32): launcher, operand padding and
the plain PyTorch version of the kernel."""
