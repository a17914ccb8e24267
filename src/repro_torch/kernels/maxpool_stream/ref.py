"""Plain PyTorch versions of the streaming max-pool kernel (K7).

``maxpool_ref`` is the oracle: a VALID max-pool whose running max starts
at -inf, as the reference's ``lax.reduce_window`` does (the port's direct
max-pool, ``core/streaming.py::maxpool_direct``). ``maxpool_stream_plain``
is the plain version of the kernel itself: it pads the input with ``NEG``
to whole row blocks and walks the reference kernel's (image, row block of
R <= ``row_block`` output rows) grid, each block the max, in fp32 and
from ``NEG``, over the pool x pool strided slices of its ``(R-1)*stride +
pool`` input rows, written back in the input's dtype. The launcher runs it
for CPU tensors; ``chip_smoke.py`` holds the CUDA kernel against it.

The two differ only where a whole window lies below ``NEG`` (-3e38): an
input of -inf pools to -inf in ``maxpool_ref`` and to -3e38 in the kernel
and its plain version, as in the reference's kernel. Both pass a NaN on,
as ``jnp.maximum`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.streaming import maxpool_direct
from repro_torch.kernels.fused_conv_pool.ref import pool_rows

NEG = -3.0e38


def pooled_size(n: int, pool: int, ps: int) -> int:
    return (n - pool) // ps + 1


def maxpool_ref(x: torch.Tensor, *, pool: int,
                stride: int = 0) -> torch.Tensor:
    """x (B, H, W, C) -> VALID max-pool (B, H_out, W_out, C) in x's
    dtype, the running max started at -inf."""
    return maxpool_direct(x, pool, stride)


def maxpool_stream_plain(x: torch.Tensor, *, pool: int, stride: int = 0,
                         row_block: int = 8) -> torch.Tensor:
    """x (B, H, W, C) -> (B, H_out, W_out, C) in x's dtype, by the
    reference kernel's grid over the ``NEG``-padded input."""
    ps = stride or pool
    B, H, W, C = x.shape
    h_out, w_out = pooled_size(H, pool, ps), pooled_size(W, pool, ps)
    R = min(row_block, h_out)
    n_rb = -(-h_out // R)
    h_pad = (n_rb * R - 1) * ps + pool
    w_pad = (w_out - 1) * ps + pool        # columns past the last window go
    xp = F.pad(x, (0, 0, 0, max(0, w_pad - W), 0, max(0, h_pad - H)),
               value=NEG)[:, :h_pad, :w_pad]
    r_in = (R - 1) * ps + pool
    out = x.new_empty((B, n_rb * R, w_out, C))
    for b in range(B):
        for r in range(n_rb):
            blk = xp[b:b + 1, r * R * ps:r * R * ps + r_in]
            out[b:b + 1, r * R:(r + 1) * R] = torch.clamp_min(
                pool_rows(blk.float(), pool, ps, R, w_out), NEG)
    return out[:, :h_out]
