"""Public wrapper of the streaming conv kernel (K6).

``conv2d_stream`` pads the input (SAME-style ``pad``), runs the VALID
conv through ``conv2d_stream_raw`` (the kernel on CUDA tensors, its plain
version on CPU tensors) and adds an optional bias. Output fp32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv_stream.kernel import (  # noqa: F401
    conv2d_stream_raw, launch_count, plain_count, reset_launch_count)


def conv2d_stream(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *, stride: int = 1,
                  pad: int = 0, row_block: int = 8, cout_block: int = 128,
                  cin_block: int = 128) -> torch.Tensor:
    """Padded streaming conv with optional bias; x (B,H,W,Cin), w
    (K,K,Cin,Cout). Returns fp32 (B, H_out, W_out, Cout)."""
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    out = conv2d_stream_raw(x, w, stride=stride, row_block=row_block,
                            cout_block=cout_block, cin_block=cin_block)
    if b is not None:
        out = out + b.float()
    return out
