"""int8 streaming-inference primitives: symmetric, zero-point-free.

The counterpart of the int8 half of ``repro/core/quantization.py``.
Padding zeros stay exact zeros in the integer domain, so the schedule's
uniform-grid padding adds exact 0 to every int32 accumulation. Every
function here is part of the bit-exactness contract between the K3
kernel, its plain version and the int32 reference model: one rounding
rule each, the same on the CPU and on the card.
"""
from __future__ import annotations

import numpy as np
import torch

INT8_QMAX = 127            # symmetric [-127, 127]: |q| == |-q| exactly

# Exact-accumulation fan bound for int8 x int8 -> int32 products summed
# in fp32: every partial sum of ``fan`` products of magnitude <= 127*127
# stays an exact fp32 integer while fan * 127^2 < 2^24. The reference
# kernel chunks its fp32 gemms by it; the port's kernel accumulates in
# int32 and needs no chunking, but ``fan_chunk`` keeps its meaning.
EXACT_FP32_FAN = (1 << 24) // (INT8_QMAX * INT8_QMAX)       # 1040


def quantize_int8_sym(x: torch.Tensor, scale) -> torch.Tensor:
    """fp32 -> symmetric int8: clip(round(x / scale), -127, 127).

    ``torch.round`` rounds half to even, as the reference does. The
    divisor is a float32 tensor on ``x``'s device: on a CUDA tensor a
    division by a Python scalar runs as a multiplication by its
    reciprocal, which rounds differently at exact halves of the scale."""
    x = x.to(torch.float32)
    s = torch.full((), float(scale), dtype=torch.float32, device=x.device)
    q = torch.round(x / s)
    return torch.clamp(q, -INT8_QMAX, INT8_QMAX).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    s = torch.full((), float(scale), dtype=torch.float32, device=q.device)
    return q.to(torch.float32) * s


def rounding_rshift(v: torch.Tensor, s) -> torch.Tensor:
    """Arithmetic right shift with round-half-up: round(v / 2^s).

    ``v`` int32; ``s`` a non-negative int or int32 tensor (e.g.
    per-output-channel shifts) up to 31. Callers guarantee
    |v| + 2^(s-1) < 2^31."""
    s = torch.as_tensor(s, dtype=torch.int32, device=v.device)
    one = torch.ones((), dtype=torch.int32, device=v.device)
    bias = torch.where(s > 0, one << torch.clamp(s - 1, min=0),
                       torch.zeros_like(one))
    return (v + bias) >> s


def requantize_i32(acc: torch.Tensor, m: torch.Tensor, shift: torch.Tensor,
                   pre_shift: int = 0, relu: bool = False) -> torch.Tensor:
    """int32 accumulator -> int8 output: fixed-point multiply + shift.

    ``y = clip(round(acc * m / 2^shift), lo, 127)`` in int32 only: a
    rounding pre-shift by the static ``pre_shift`` makes headroom so
    ``(acc >> p) * m`` cannot overflow, then the per-channel mantissa
    ``m`` and the remaining ``shift - pre_shift`` rounding shift apply
    the scale ``m * 2^-shift`` (``requant_params``). ``relu=True`` folds
    max(x, 0) into the lower clip bound."""
    v = rounding_rshift(acc, pre_shift) if pre_shift else acc
    v = v * m.to(torch.int32)
    v = rounding_rshift(v, shift.to(torch.int32) - pre_shift)
    lo = 0 if relu else -INT8_QMAX
    return torch.clamp(v, lo, INT8_QMAX).to(torch.int8)


def requant_params(scale_ratio, acc_bound: int, bits_m: int = 7):
    """Host-side: fixed-point (m, shift, pre_shift) for ``requantize_i32``.

    ``scale_ratio`` (out_c,) float64 = s_in * s_w[c] / s_out, the real
    multiplier approximated as ``m * 2^-shift`` with ``m`` a
    ``bits_m``-bit normalised mantissa. ``acc_bound`` bounds |acc + bias|
    so the static per-layer ``pre_shift`` guarantees (acc >> p) * m <
    2^31.

    Returns (m int32 (out_c,), shift int32 (out_c,), pre_shift int).
    """
    r = np.maximum(np.asarray(scale_ratio, np.float64), 1e-30)
    m_hi = float(2 ** bits_m - 1)
    # headroom: (acc_bound >> p) * m_hi (+ rounding bias) must fit int31
    need = np.log2(max(acc_bound, 1) * m_hi) if acc_bound > 0 else 0.0
    pre_shift = max(0, int(np.ceil(need)) - 30)
    shift = np.floor(np.log2(m_hi / r)).astype(np.int64)
    m = np.round(r * np.exp2(shift)).astype(np.int64)
    # normalise after rounding: keep m in [2^(bits_m-1), 2^bits_m - 1]
    low = m < 2 ** (bits_m - 1)
    shift = np.where(low, shift + 1, shift)
    m = np.where(low, np.round(r * np.exp2(shift)), m).astype(np.int64)
    high = m > m_hi
    shift = np.where(high, shift - 1, shift)
    m = np.where(high, np.round(r * np.exp2(shift)), m).astype(np.int64)
    # the kernel computes shift - pre_shift: keep it a valid >= 0 shift,
    # and re-derive m AT a clipped shift so the scale stays right
    clipped = np.clip(shift, pre_shift, 31)
    moved = clipped != shift
    m = np.where(moved, np.round(r * np.exp2(clipped)), m)
    shift = clipped
    m = np.clip(m, 1, m_hi)
    return (m.astype(np.int32), shift.astype(np.int32), pre_shift)
