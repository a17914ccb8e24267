"""Public wrapper of the streaming max-pool kernel (K7).

``maxpool_stream`` runs a VALID max-pool through ``maxpool_stream_raw``:
the kernel, once per call, on CUDA tensors; its plain version on CPU
tensors. The reference's op also takes ``interpret=``; the port has no
interpret mode, so this one does not.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.maxpool_stream.kernel import (  # noqa: F401
    launch_count, maxpool_stream_raw, plain_count, reset_launch_count)


def maxpool_stream(x: torch.Tensor, *, pool: int, stride: int = 0,
                   row_block: int = 8) -> torch.Tensor:
    """x (B, H, W, C) float32 or bfloat16 -> (B, H_out, W_out, C), VALID;
    ``stride`` 0 means ``pool``, smaller values overlap (AlexNet's 3/2).
    ``row_block`` is the plain version's row block (the reference's grid)
    and the most output rows one CTA of the kernel takes; no output
    depends on it, since a max is exact in any order."""
    return maxpool_stream_raw(x, pool=pool, stride=stride,
                              row_block=row_block)
