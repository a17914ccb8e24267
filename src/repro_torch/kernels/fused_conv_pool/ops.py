"""Public wrapper of the fused conv + ReLU + max-pool kernel (K5).

``fused_conv_pool`` pads the input (SAME-style ``pad``) and runs conv +
bias + ReLU + max-pool through ``fused_conv_pool_raw`` (the kernel on
CUDA tensors, every conv group in one launch; its plain version on CPU
tensors). Output fp32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.fused_conv_pool.kernel import (  # noqa: F401
    fused_conv_pool_raw, launch_count, plain_count, reset_launch_count)


def fused_conv_pool(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *, stride: int = 1,
                    pad: int = 0, pool: int = 2, pool_stride: int = 0,
                    relu: bool = True, groups: int = 1, row_block: int = 8,
                    cout_block: int = 128,
                    cin_block: int = 128) -> torch.Tensor:
    """Conv + bias + ReLU + max-pool, fused; x (B,H,W,Cin), w
    (K,K,Cin/groups,Cout). ``pool_stride`` 0 means ``pool``; smaller
    values overlap (AlexNet 3/2)."""
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    return fused_conv_pool_raw(x, w, b, stride=stride, pool=pool,
                               pool_stride=pool_stride, relu=relu,
                               groups=groups, row_block=row_block,
                               cout_block=cout_block, cin_block=cin_block)
