"""Streaming max-pool (kernel K7): launcher, public wrapper and the plain
PyTorch versions of the kernel."""
from repro_torch.kernels.maxpool_stream.ops import (  # noqa: F401
    maxpool_stream)
from repro_torch.kernels.maxpool_stream.ref import maxpool_ref  # noqa: F401
