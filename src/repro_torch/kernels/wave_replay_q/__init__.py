"""Per-layer wave-replay megakernel (int8, kernel K3): launcher, operand
padding, the int32 oracle and the plain PyTorch version of the kernel."""
