"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version; ``_build`` compiles ``csrc/*.cu`` at first use."""
