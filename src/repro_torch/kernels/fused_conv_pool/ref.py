"""Plain PyTorch versions of the fused conv + ReLU + max-pool kernel (K5).

``conv_pool_ref`` is the direct oracle: conv, bias, ReLU and an
overlapping max-pool. ``fused_conv_pool_plain`` is the plain version of
the kernel itself: for each conv group it walks the reference kernel's
grid (pooled row block x cout block x cin block; the batch rides along),
computes the conv rows each block's pooled rows need (recomputing the
overlap rows at block edges, as the kernel does), sums cin blocks in
fp32, then adds the bias, applies the ReLU and pools, in the CUDA
kernel's epilogue order. The launcher runs it for CPU tensors;
``chip_smoke.py`` holds the CUDA kernel against it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.streaming import conv2d_direct, maxpool_direct
from repro_torch.kernels.conv_stream.ref import conv_block


def conv_pool_ref(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *, stride: int = 1,
                  pool: int = 2, pool_stride: int = 0, relu: bool = True,
                  groups: int = 1) -> torch.Tensor:
    """VALID conv (+ bias) (+ ReLU) + max-pool, fp32."""
    y = conv2d_direct(x.float(), w.float(), stride, 0, groups)
    if b is not None:
        y = y + b.float()
    if relu:
        y = torch.relu(y)
    return maxpool_direct(y, pool, pool_stride or pool)


def pool_rows(a: torch.Tensor, pool: int, ps: int, rows: int,
              cols: int) -> torch.Tensor:
    """Max-pool (B, ch, cw, C) conv rows to (B, rows, cols, C): the max
    over the pool window's strided slices."""
    out = None
    for dy in range(pool):
        for dx in range(pool):
            s = a[:, dy:dy + (rows - 1) * ps + 1:ps,
                  dx:dx + (cols - 1) * ps + 1:ps]
            out = s if out is None else torch.maximum(out, s)
    return out


def fused_conv_pool_plain(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None, *,
                          stride: int = 1, pool: int = 2,
                          pool_stride: int = 0, relu: bool = True,
                          groups: int = 1, row_block: int = 8,
                          cout_block: int = 128,
                          cin_block: int = 128) -> torch.Tensor:
    """x (B, H, W, Cin) pre-padded, w (K, K, Cin/groups, Cout), b (Cout,)
    or None: the pooled fp32 (B, Hp, Wp, Cout)."""
    x, w = x.float(), w.float()
    ps = pool_stride or pool
    B, H, W, Cin = x.shape
    K, Cout = w.shape[0], w.shape[3]
    H_out = (H - K) // stride + 1
    W_out = (W - K) // stride + 1
    Hp = (H_out - pool) // ps + 1
    Wp = (W_out - pool) // ps + 1
    RP = max(1, min((row_block - pool) // ps + 1, Hp))
    cw = (Wp - 1) * ps + pool               # conv columns the pool reads
    cin_g, opg = Cin // groups, Cout // groups
    out = x.new_empty((B, Hp, Wp, Cout))
    for gi in range(groups):
        xg = x[..., gi * cin_g:(gi + 1) * cin_g]
        wg = w[..., gi * opg:(gi + 1) * opg]
        for p0 in range(0, Hp, RP):
            prows = min(RP, Hp - p0)
            ch = (prows - 1) * ps + pool    # conv rows this block needs
            y0 = p0 * ps * stride
            xin = xg[:, y0:y0 + (ch - 1) * stride + K]
            for co in range(0, opg, cout_block):
                a = conv_block(xin, wg, stride, ch, cw, cout_block,
                               cin_block, co)
                c0 = gi * opg + co
                c1 = c0 + a.shape[-1]
                if b is not None:
                    a = a + b[c0:c1].float()
                if relu:
                    a = torch.relu(a)
                out[:, p0:p0 + prows, :, c0:c1] = pool_rows(a, pool, ps,
                                                            prows, Wp)
    return out
