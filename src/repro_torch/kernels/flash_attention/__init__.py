"""Flash-attention forward (kernel K9): launcher, public wrapper and the
plain PyTorch versions of the kernel."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
