"""Exact integer versions of the int8 wave-replay megakernel.

``quant_layer_ref`` is the int32 oracle: a direct conv with every
product and sum exact, the same ``requantize_i32`` as the kernel's
epilogue, the same ``residual_add_i8`` and an int8 max-pool. PyTorch has
no integer convolution or matmul on CUDA, so the conv runs as an im2col
gemm in float64: every product and partial sum is an integer below
2^53 (a fan of at most 2304 x 127^2), so the result is exact on any
device and in any order. No cuDNN convolution is involved.

``wave_replay_q_plain`` is the plain version of the kernel itself: the
same padded operands as the CUDA launcher, the same operand table walked
in the same (batch block, tile, chain) order, the same padded int8
output with masked lanes exactly 0. The launcher runs it for CPU
tensors; tests and ``chip_smoke.py`` hold the CUDA kernel bit-exactly
against it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.decomposition import ConvLayer
from repro_torch.core.quantization import INT8_QMAX, requantize_i32
from repro_torch.core.schedule import (OP_C0, OP_IX, OP_IY, OP_TX, OP_TY,
                                       OP_VC, OP_VR, OP_WC0, KernelProgram,
                                       batch_grid)
from repro_torch.kernels.wave_replay.ref import (block_mask,
                                                 pool_max_subsampled,
                                                 step_contrib)


def residual_add_i8(q: torch.Tensor, r: torch.Tensor,
                    relu: bool) -> torch.Tensor:
    """The int8 accumulation-buffer add: both operands share one
    calibrated scale, so the sum is an int32 add followed by the
    ReLU-folded int8 clip."""
    s = q.to(torch.int32) + r.to(torch.int32)
    lo = 0 if relu else -INT8_QMAX
    return torch.clamp(s, lo, INT8_QMAX).to(torch.int8)


def maxpool_int(x: torch.Tensor, window: int,
                stride: int = 0) -> torch.Tensor:
    """VALID max-pool over integer (B, H, W, C) activations."""
    stride = stride or window
    oh = (x.shape[1] - window) // stride + 1
    ow = (x.shape[2] - window) // stride + 1
    return pool_max_subsampled(x, pool=window, stride=stride,
                               out_h=oh, out_w=ow)


def conv_i32_exact(layer: ConvLayer, xq: torch.Tensor,
                   wq: torch.Tensor) -> torch.Tensor:
    """int8 (B, H, W, Cin) x int8 (K, K, Cin/groups, Cout) -> exact int32
    (B, Ho, Wo, Cout) accumulators, as float64 im2col gemms per group."""
    l = layer
    K, s = l.kernel, l.stride
    x = F.pad(xq.to(torch.float64), (0, 0, l.pad, l.pad, l.pad, l.pad))
    w = wq.to(torch.float64)
    B = x.shape[0]
    oh = (x.shape[1] - K) // s + 1
    ow = (x.shape[2] - K) // s + 1
    cg, opg = w.shape[2], l.out_c // l.groups

    def tap(ky, kx, c0, cw):
        return x[:, ky:ky + (oh - 1) * s + 1:s,
                 kx:kx + (ow - 1) * s + 1:s, c0:c0 + cw]

    if l.groups > 1 and cg == 1:
        # depthwise: out channel o reads in channel o // opg
        acc = x.new_zeros((B, oh, ow, l.out_c))
        for ky in range(K):
            for kx in range(K):
                xt = tap(ky, kx, 0, l.in_c)
                if opg > 1:
                    xt = xt.repeat_interleave(opg, dim=-1)
                acc = acc + xt * w[ky, kx, 0, :]
        return acc.to(torch.int32)
    cols = []
    for gi in range(l.groups):
        # fan order (ky, kx, c) matches the HWIO weight reshape
        pat = torch.cat([tap(ky, kx, gi * cg, cg) for ky in range(K)
                         for kx in range(K)], -1).reshape(-1, K * K * cg)
        cols.append(pat @ w[:, :, :, gi * opg:(gi + 1) * opg]
                    .reshape(K * K * cg, opg))
    return torch.cat(cols, -1).reshape(B, oh, ow, l.out_c).to(torch.int32)


def quant_layer_ref(layer: ConvLayer, xq: torch.Tensor, wq: torch.Tensor,
                    bq: torch.Tensor, m: torch.Tensor, shift: torch.Tensor,
                    *, pre_shift: int = 0, relu: bool = False,
                    fuse_pool: bool = False,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One quantized CONV(+POOL) layer, int32 end to end.

    ``xq`` (B, H, W, Cin) int8; ``wq`` (K, K, Cin/groups, Cout) int8;
    ``bq``/``m``/``shift`` (Cout,) int32. ``residual`` (int8, the layer's
    output geometry and output scale) is added after a requantize
    WITHOUT the ReLU clip, then ReLU-clipped (``residual_add_i8``).
    Returns int8, post-pool dims when ``fuse_pool``."""
    l = layer
    dev = xq.device
    acc = conv_i32_exact(l, xq, wq) + bq.to(dev, torch.int32)
    q = requantize_i32(acc, m.to(dev), shift.to(dev), pre_shift,
                       relu=relu and residual is None)
    if residual is not None:
        if fuse_pool:
            raise ValueError(f"{l.name}: residual add cannot fuse with "
                             f"the pool epilogue")
        q = residual_add_i8(q, residual, relu)
    if fuse_pool:
        if l.pool <= 1:
            raise ValueError(f"{l.name}: fuse_pool without a pool")
        q = maxpool_int(q, l.pool, l.pool_stride or l.pool)
    return q


def quant_layer_ref_from_quant(layer: ConvLayer, xq: torch.Tensor, quant,
                               relu: bool = False, fuse_pool: bool = False,
                               residual: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Unpack a ``LayerQuant`` (quant/calibrate.py) into the oracle."""
    wq, bq, m, shift = quant.device_arrays(xq.device)
    return quant_layer_ref(layer, xq, wq, bq, m, shift,
                           pre_shift=quant.pre_shift, relu=relu,
                           fuse_pool=fuse_pool, residual=residual)


def wave_replay_q_plain(kp: KernelProgram, xq: torch.Tensor,
                        wq: torch.Tensor, bq: torch.Tensor, m: torch.Tensor,
                        shift: torch.Tensor, table: torch.Tensor, *,
                        pre_shift: int = 0,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The K3 kernel's function in plain PyTorch, on any device.

    Same operands and result as ``kernel.wave_replay_q_raw``: ``xq`` (B,
    pad_h, pad_w, in_c_kpad) int8, ``wq`` (K, K, w_in_kpad, out_c_pad)
    int8, ``bq``/``m``/``shift`` (1, out_c_pad) int32, ``table``
    (n_chain, n_tiles, 8) int32, optional int8 ``residual`` at the padded
    output geometry. Each chain step's partial sums are an exact float64
    gemm, summed in int32. Returns (B, out_h_pad, out_w_pad, out_c_pad)
    int8 with the masked lanes exactly 0.
    """
    B = xq.shape[0]
    n_bb, bb = batch_grid(B, kp.batch_block)
    if n_bb * bb != B:     # zero images accumulate exact zeros; cropped
        xq = torch.cat([xq, xq.new_zeros((n_bb * bb - B,)
                                         + tuple(xq.shape[1:]))])
        if residual is not None:
            residual = torch.cat([residual, residual.new_zeros(
                (n_bb * bb - B,) + tuple(residual.shape[1:]))])
    xf, wf = xq.to(torch.float64), wq.to(torch.float64)
    tab = table.tolist()
    out = xq.new_empty((n_bb * bb, kp.out_h_pad, kp.out_w_pad,
                        kp.out_c_pad))
    bh, bw = kp.blk_h, kp.blk_w
    for bi in range(n_bb):
        b0 = bi * bb
        for t in range(kp.n_tiles):
            acc = torch.zeros((bb, kp.acc_h, kp.acc_w, kp.out_c_pad),
                              dtype=torch.int32, device=xq.device)
            for k in range(kp.n_chain):
                r = tab[k][t]
                x = xf[b0:b0 + bb, r[OP_IY]:r[OP_IY] + kp.ih,
                       r[OP_IX]:r[OP_IX] + kp.iw,
                       r[OP_C0]:r[OP_C0] + kp.c_width]
                w = wf[:, :, r[OP_WC0]:r[OP_WC0] + kp.fan_width, :]
                acc = acc + step_contrib(kp, x, w).to(torch.int32)
            r = tab[kp.n_chain - 1][t]
            y0, x0 = r[OP_TY] * bh, r[OP_TX] * bw
            res = None if residual is None \
                else residual[b0:b0 + bb, y0:y0 + bh, x0:x0 + bw]
            out[b0:b0 + bb, y0:y0 + bh, x0:x0 + bw] = epilogue_q(
                kp, acc, bq[0], m[0], shift[0], pre_shift, res,
                r[OP_VR], r[OP_VC])
    return out[:B]


def epilogue_q(kp: KernelProgram, acc: torch.Tensor, bq: torch.Tensor,
               m: torch.Tensor, shift: torch.Tensor, pre_shift: int,
               residual: Optional[torch.Tensor], vr: int,
               vc: int) -> torch.Tensor:
    """The last chain step's int32 epilogue over one tile's accumulator:
    bias, requantize (ReLU folded into the clip only without a
    residual), the residual add and clip, the int8 pool, then the write
    mask. ``bq``/``m``/``shift`` are ``(out_c_pad,)``. Returns the int8
    (bb, blk_h, blk_w, out_c_pad) output block."""
    q = requantize_i32(acc + bq, m, shift, pre_shift,
                       relu=kp.relu and not kp.residual)
    if residual is not None:
        q = residual_add_i8(q, residual, kp.relu)
    if kp.fuse_pool:
        q = pool_max_subsampled(q, pool=kp.pool, stride=kp.pool_stride,
                                out_h=kp.blk_h, out_w=kp.blk_w)
    return torch.where(block_mask(kp, vr, vc, q.device), q,
                       q.new_zeros(()))
