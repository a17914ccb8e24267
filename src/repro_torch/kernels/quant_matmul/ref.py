"""Plain PyTorch versions of the int8 quantized matmul kernel (K8).

Three oracles, as in the reference (paper Table 2: fixed-point operands,
32-bit accumulators, scale on write-back):

  * ``quant_matmul_acc_ref``: the exact int32 accumulator, computed as a
    float64 gemm (every product and partial sum is an integer below 2^53,
    so exact), on the CPU and on the card alike; never an integer
    library call.
  * ``quant_matmul_ref``: the accumulator dequantized in fp32 as
    ``(acc * sx) * sw[n]``, in that order.
  * ``quant_matmul_requant_ref``: the accumulator requantized to int8
    through the port's fixed-point ``requant_params``/``requantize_i32``.

``quant_matmul_plain`` is the plain version of the kernel itself: it
walks the reference kernel's (M block, N block, K block) grid with an
int32 accumulator carried across K blocks (each block's product exact in
float64) and dequantizes on the last K block in the oracle's order. The
reference's Pallas kernel multiplies ``sx * sw`` first and is up to 2 ULP off
its own oracle; the port follows the oracle. The launcher runs the plain
version for CPU tensors; ``chip_smoke.py`` holds the CUDA kernel against
it and the oracles.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantization import requant_params, requantize_i32


def scale_tensor(s, device: torch.device) -> torch.Tensor:
    """A scale (number, array or tensor) as fp32 on ``device``."""
    return torch.as_tensor(s, dtype=torch.float32, device=device)


def quant_matmul_acc_ref(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> exact (M, N) int32 accumulator, as a
    float64 gemm."""
    return (xq.double() @ wq.double()).to(torch.int32)


def dequantize(acc: torch.Tensor, sx, sw) -> torch.Tensor:
    """``(acc * sx) * sw[None, :]`` in fp32."""
    return acc.float() * scale_tensor(sx, acc.device) \
        * scale_tensor(sw, acc.device)[None, :]


def quant_matmul_ref(xq: torch.Tensor, wq: torch.Tensor, sx,
                     sw) -> torch.Tensor:
    """Dequantized fp32 output: acc * sx * sw[None, :]."""
    return dequantize(quant_matmul_acc_ref(xq, wq), sx, sw)


def _float64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, np.float64)


def quant_matmul_requant_ref(xq: torch.Tensor, wq: torch.Tensor, sx, sw,
                             out_scale: float) -> torch.Tensor:
    """int8 output in ``out_scale``: the fixed-point multiplier/shift pairs
    from ``requant_params`` with the exact accumulator bound for this K,
    saturating at +-127."""
    acc_bound = int(xq.shape[-1]) * 127 * 128
    ratio = _float64(sx) * _float64(sw) / float(out_scale)
    m, shift, pre_shift = requant_params(ratio, acc_bound)
    acc = quant_matmul_acc_ref(xq, wq)
    return requantize_i32(acc, torch.as_tensor(m, device=acc.device),
                          torch.as_tensor(shift, device=acc.device),
                          pre_shift)


def quant_matmul_plain(xq: torch.Tensor, wq: torch.Tensor, sx, sw, *,
                       block_m: int = 128, block_n: int = 128,
                       block_k: int = 128) -> torch.Tensor:
    """xq (M, K) int8, wq (K, N) int8, sx scalar, sw (N,): fp32 (M, N) by
    the reference kernel's grid."""
    M, K = xq.shape
    N = wq.shape[1]
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    sx = scale_tensor(sx, xq.device)
    sw = scale_tensor(sw, xq.device)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    for m0 in range(0, M, bm):
        for n0 in range(0, N, bn):
            acc = torch.zeros((min(bm, M - m0), min(bn, N - n0)),
                              dtype=torch.int32, device=xq.device)
            for k0 in range(0, K, bk):
                acc += quant_matmul_acc_ref(xq[m0:m0 + bm, k0:k0 + bk],
                                            wq[k0:k0 + bk, n0:n0 + bn])
            out[m0:m0 + bm, n0:n0 + bn] = dequantize(acc, sx,
                                                     sw[n0:n0 + bn])
    return out
