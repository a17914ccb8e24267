"""Public wrapper for the per-layer wave-replay megakernel.

``wave_replay_layer`` takes a layer's *natural* tensors (unpadded NHWC
input, per-group HWIO weights, optional bias), pads them to the
KernelProgram's buffer geometry, launches the kernel ONCE, and crops the
valid output — the whole streamed layer in a single launch.

``launch_count()`` reads the launcher's count of launches of the
hand-written kernel (one per ``wave_replay_layer`` call on a CUDA
tensor); ``plain_count()`` its count of plain-version runs on CPU
tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.schedule import KernelProgram
from repro_torch.kernels.wave_replay.kernel import (  # noqa: F401
    launch_count, plain_count, reset_launch_count, wave_replay_raw)


def pad_input(kp: KernelProgram, x: torch.Tensor) -> torch.Tensor:
    """Pad an input activation to the program's buffer geometry.

    Conv padding goes top/left; the tile grid's trailing zeros (or trim,
    when the conv window never reaches the last rows) complete ``pad_h``
    x ``pad_w``; channels round up to whole chunks.
    """
    l = kp.wave.program.layer
    xp = F.pad(x, (0, kp.in_c_kpad - x.shape[-1],
                   l.pad, max(0, kp.pad_w - l.in_w - l.pad),
                   l.pad, max(0, kp.pad_h - l.in_h - l.pad)))
    return xp[:, :kp.pad_h, :kp.pad_w].contiguous()


def pad_operands(kp: KernelProgram, x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor]):
    """Pad (x, w, b) to the megakernel's buffer geometry.

    Weights keep their natural per-group layout (``w_in_kpad`` is the
    per-group fan for grouped layers). All padding is zeros, which add
    exact 0.0 into every accumulation.
    """
    g = kp.wave.program
    l = g.layer
    xp = pad_input(kp, x.float())
    wp = F.pad(w.float(), (0, g.out_c_pad - l.out_c,
                           0, kp.w_in_kpad - w.shape[2])).contiguous()
    bias = xp.new_zeros((1, g.out_c_pad))
    if b is not None:
        bias[0, :l.out_c] = b.float()
    return xp, wp, bias


def pad_residual(kp: KernelProgram, r: torch.Tensor) -> torch.Tensor:
    """Pad a residual activation (B, out_h, out_w, out_c) to the kernel's
    padded output geometry (zeros land in the masked lanes)."""
    g = kp.wave.program
    return F.pad(r.float(), (0, g.out_c_pad - g.layer.out_c,
                             0, kp.out_w_pad - kp.out_w,
                             0, kp.out_h_pad - kp.out_h)).contiguous()


def wave_replay_layer(kp: KernelProgram, x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None,
                      table: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Execute one streamed CONV layer as ONE kernel launch.

    ``x`` (B, in_h, in_w, in_c); ``w`` (K, K, in_c/groups, out_c);
    ``table`` defaults to the program's own operand table, uploaded to
    ``x``'s device. Programs lowered with ``residual=True`` take the
    residual activation (B, out_h, out_w, out_c), added after bias and
    before ReLU. Returns the valid (B, out_h, out_w, out_c) fp32 output —
    pooled dims when the program fuses its pool.
    """
    l = kp.wave.program.layer
    if table is None:
        table = torch.as_tensor(kp.operand_table(), device=x.device)
    if kp.residual and residual is None:
        raise ValueError(f"{l.name}: program lowered with residual=True "
                         f"needs the residual operand")
    xp, wp, bias = pad_operands(kp, x, w, b)
    rp = pad_residual(kp, residual) if kp.residual else None
    y = wave_replay_raw(kp, xp, wp, bias, table, residual=rp)
    return y[:, :kp.out_h, :kp.out_w, :l.out_c]
