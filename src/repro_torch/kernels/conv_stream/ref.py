"""Plain PyTorch versions of the streaming conv kernel (K6).

``conv2d_ref`` is the direct-conv oracle. ``conv2d_stream_plain`` is the
plain version of the kernel itself: it takes the same pre-padded input
and weights as the launcher and walks the reference kernel's grid (row
block x cout block x cin block; the batch rides along), one im2col
product per block with the fp32 sum carried across cin blocks, and
returns the same (B, H_out, W_out, Cout) fp32 output. The launcher runs
it for CPU tensors; ``chip_smoke.py`` holds the CUDA kernel against it.
"""
from __future__ import annotations

import torch

from repro_torch.core.streaming import conv2d_direct


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               pad: int = 0) -> torch.Tensor:
    """x (B,H,W,Cin), w (K,K,Cin,Cout) -> fp32 (B,Ho,Wo,Cout)."""
    return conv2d_direct(x.float(), w.float(), stride, pad)


def patches(x: torch.Tensor, k: int, stride: int, rows: int,
            cols: int) -> torch.Tensor:
    """The im2col matrix of ``rows`` x ``cols`` conv outputs whose window
    starts at x's origin: (B * rows * cols, K * K * C), the reduction in
    (ky, kx, c) order, which is HWIO weights' row order."""
    taps = [x[:, ky:ky + (rows - 1) * stride + 1:stride,
              kx:kx + (cols - 1) * stride + 1:stride, :]
            for ky in range(k) for kx in range(k)]
    return torch.cat(taps, -1).reshape(-1, k * k * x.shape[-1])


def conv_block(x: torch.Tensor, w: torch.Tensor, stride: int, rows: int,
               cols: int, cout_block: int, cin_block: int,
               co: int) -> torch.Tensor:
    """One (row block, cout block) of a VALID conv: (B, rows, cols, cb)
    fp32 for output channels ``co:co + cout_block``, summed over cin
    blocks in order. ``x`` starts at the block's first input row."""
    k, cin = w.shape[0], w.shape[2]
    co1 = min(co + cout_block, w.shape[3])
    acc = None
    for ci in range(0, cin, cin_block):
        ci1 = min(ci + cin_block, cin)
        part = patches(x[..., ci:ci1], k, stride, rows, cols) @ \
            w[:, :, ci:ci1, co:co1].reshape(-1, co1 - co)
        acc = part if acc is None else acc + part
    return acc.reshape(x.shape[0], rows, cols, co1 - co)


def conv2d_stream_plain(x: torch.Tensor, w: torch.Tensor, *,
                        stride: int = 1, row_block: int = 8,
                        cout_block: int = 128,
                        cin_block: int = 128) -> torch.Tensor:
    """x (B, H, W, Cin) pre-padded, w (K, K, Cin, Cout): the VALID conv,
    fp32 (B, H_out, W_out, Cout), by the reference kernel's grid."""
    x, w = x.float(), w.float()
    B, H, W, _ = x.shape
    K, Cout = w.shape[0], w.shape[3]
    H_out = (H - K) // stride + 1
    W_out = (W - K) // stride + 1
    R = min(row_block, H_out)
    out = x.new_empty((B, H_out, W_out, Cout))
    for r0 in range(0, H_out, R):
        rows = min(R, H_out - r0)
        xin = x[:, r0 * stride:r0 * stride + (rows - 1) * stride + K]
        for co in range(0, Cout, cout_block):
            blk = conv_block(xin, w, stride, rows, W_out, cout_block,
                             cin_block, co)
            out[:, r0:r0 + rows, :, co:co + blk.shape[-1]] = blk
    return out
