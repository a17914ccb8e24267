"""Plain PyTorch versions of the wave-replay megakernel.

``wave_replay_ref`` is the direct-conv oracle (bias, residual add, ReLU,
overlapping max-pool, in the kernel epilogue's order). ``wave_replay_plain``
is the plain version of the kernel itself: it takes the same padded
operands as the CUDA launcher, walks the same operand table in the same
(batch block, tile, chain) order as the reference megakernel, and returns
the same padded output, masked lanes included. The launcher runs it for
CPU tensors; tests and ``chip_smoke.py`` hold the CUDA kernel against it.

``FP32_TOL`` is the one tolerance every fp32 comparison of the port uses.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.schedule import (OP_C0, OP_IX, OP_IY, OP_TX, OP_TY,
                                       OP_VC, OP_VR, OP_WC0, KernelProgram,
                                       batch_grid)
from repro_torch.core.streaming import conv2d_direct, maxpool_direct

# max|got - want| <= FP32_TOL * max(1, max|want|). The kernel and the plain
# version reduce in im2col order, the references in their conv's own
# order; fp32 sums of AlexNet's fans (up to 2304 terms) differ by far less
# than this relative to the output's scale.
FP32_TOL = 1e-4


def fp32_error(got, want) -> "tuple[float, float]":
    """``(max |got - want|, allowed)`` under ``FP32_TOL``; accepts tensors
    on any device or numpy arrays of the same shape."""
    def host(a):
        if torch.is_tensor(a):
            return a.detach().double().cpu()
        return torch.from_numpy(np.array(a, np.float64))

    g, w = host(got), host(want)
    if g.shape != w.shape:
        raise ValueError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    scale = float(w.abs().max()) if w.numel() else 0.0
    return err, FP32_TOL * max(1.0, scale)


def wave_replay_ref(layer, x, w, b=None, *, relu: bool = False,
                    fuse_pool: bool = False, residual=None):
    """Direct conv + bias (+ residual + ReLU + max-pool), NHWC/HWIO."""
    l = layer
    y = conv2d_direct(x.float(), w.float(), l.stride, l.pad, l.groups)
    if b is not None:
        y = y + b.float()
    if residual is not None:          # accumulation-buffer add, pre-ReLU
        if fuse_pool:
            raise ValueError(f"{l.name}: residual add cannot fuse with "
                             f"the pool epilogue")
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    if fuse_pool:
        y = maxpool_direct(y, l.pool, l.pool_stride or l.pool)
    return y


def pool_max_subsampled(a: torch.Tensor, *, pool: int, stride: int,
                        out_h: int, out_w: int) -> torch.Tensor:
    """Max-pool over the trailing (H, W, C) dims of ``a`` as the max over
    ``pool*pool`` strided slices — each slice is one (dy, dx) tap of every
    pool window, which handles overlapping pools (stride < pool)."""
    out = None
    for dy in range(pool):
        for dx in range(pool):
            s = a[..., dy:dy + (out_h - 1) * stride + 1:stride,
                  dx:dx + (out_w - 1) * stride + 1:stride, :]
            out = s if out is None else torch.maximum(out, s)
    return out


def _step_contrib(kp: KernelProgram, x: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """One chain step's partial sums over a (bb, ih, iw, c_width) window
    and the step's (K, K, fan_width, out_c_pad) weight slice."""
    l = kp.wave.program.layer
    K, s = l.kernel, l.stride
    B, cin = x.shape[0], x.shape[-1]
    fan, out_c = w.shape[2], w.shape[3]
    ah, aw = kp.acc_h, kp.acc_w

    def tap(ky, kx, c0=0, cw=None):
        cw = cin if cw is None else cw
        return x[:, ky:ky + (ah - 1) * s + 1:s,
                 kx:kx + (aw - 1) * s + 1:s, c0:c0 + cw]

    def im2col(c0, cw):
        # flat fan order (ky, kx, c) — matches the HWIO weight reshape
        taps = [tap(ky, kx, c0, cw) for ky in range(K) for kx in range(K)]
        return torch.cat(taps, -1).reshape(B * ah * aw, K * K * cw)

    if kp.groups > 1 and fan == 1:
        # depthwise: out channel o reads in channel o // opg
        opg = out_c // kp.groups
        contrib = x.new_zeros((B, ah, aw, out_c))
        for ky in range(K):
            for kx in range(K):
                xt = tap(ky, kx)
                if opg > 1:           # channel-multiplier fan-out
                    xt = xt.repeat_interleave(opg, dim=-1)
                contrib = contrib + xt * w[ky, kx, 0, :]
        return contrib
    if kp.groups == 1:
        acc = im2col(0, cin) @ w.reshape(K * K * cin, out_c)
    else:
        opg = out_c // kp.groups
        acc = torch.cat(
            [im2col(gi * fan, fan)
             @ w[:, :, :, gi * opg:(gi + 1) * opg].reshape(K * K * fan, opg)
             for gi in range(kp.groups)], -1)
    return acc.reshape(B, ah, aw, out_c)


def wave_replay_plain(kp: KernelProgram, xp: torch.Tensor, wp: torch.Tensor,
                      bias: torch.Tensor, table: torch.Tensor,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device.

    Same operands and result as ``kernel.wave_replay_raw``: ``xp`` (B,
    pad_h, pad_w, in_c_kpad), ``wp`` (K, K, w_in_kpad, out_c_pad), ``bias``
    (1, out_c_pad), ``table`` (n_chain, n_tiles, 8) int32, optional
    ``residual`` at the padded output geometry. Returns (B, out_h_pad,
    out_w_pad, out_c_pad) with the masked lanes exactly 0.
    """
    B = xp.shape[0]
    n_bb, bb = batch_grid(B, kp.batch_block)
    if n_bb * bb != B:     # zero images convolve to exact zeros; cropped
        fill = (n_bb * bb - B,) + tuple(xp.shape[1:])
        xp = torch.cat([xp, xp.new_zeros(fill)])
        if residual is not None:
            residual = torch.cat([residual, residual.new_zeros(
                (n_bb * bb - B,) + tuple(residual.shape[1:]))])
    tab = table.tolist()
    out = xp.new_empty((n_bb * bb, kp.out_h_pad, kp.out_w_pad,
                        kp.out_c_pad))
    bh, bw = kp.blk_h, kp.blk_w
    rows = torch.arange(bh, device=xp.device)[:, None]
    cols = torch.arange(bw, device=xp.device)[None, :]
    for bi in range(n_bb):
        b0 = bi * bb
        for t in range(kp.n_tiles):
            acc = xp.new_zeros((bb, kp.acc_h, kp.acc_w, kp.out_c_pad))
            for k in range(kp.n_chain):
                r = tab[k][t]
                x = xp[b0:b0 + bb, r[OP_IY]:r[OP_IY] + kp.ih,
                       r[OP_IX]:r[OP_IX] + kp.iw,
                       r[OP_C0]:r[OP_C0] + kp.c_width]
                w = wp[:, :, r[OP_WC0]:r[OP_WC0] + kp.fan_width, :]
                acc = acc + _step_contrib(kp, x, w)
            # epilogue of the last chain step: bias, residual, ReLU, pool,
            # then the masked write of the tile's output block
            r = tab[kp.n_chain - 1][t]
            y0, x0 = r[OP_TY] * bh, r[OP_TX] * bw
            a = acc + bias[0]
            if residual is not None:
                a = a + residual[b0:b0 + bb, y0:y0 + bh, x0:x0 + bw]
            if kp.relu:
                a = torch.relu(a)
            if kp.fuse_pool:
                a = pool_max_subsampled(a, pool=kp.pool,
                                        stride=kp.pool_stride,
                                        out_h=bh, out_w=bw)
            mask = ((rows < r[OP_VR]) & (cols < r[OP_VC]))[None, :, :, None]
            out[b0:b0 + bb, y0:y0 + bh, x0:x0 + bw] = torch.where(
                mask, a, a.new_zeros(()))
    return out[:B]
