"""Public wrappers for the int8 wave-replay megakernel.

``wave_replay_q_layer`` takes a layer's natural quantized tensors
(unpadded int8 input, per-group int8 weights, int32 bias and requantize
vectors), pads them to the KernelProgram's buffer geometry (integer
zeros, exact in every accumulation), launches the kernel ONCE and crops
the valid int8 output.

``launch_count()`` reads the launcher's count of launches of the
hand-written kernel (one per ``wave_replay_q_layer`` call on a CUDA
tensor); ``plain_count()`` its count of plain-version runs on CPU
tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.schedule import KernelProgram
from repro_torch.kernels.wave_replay.ops import pad_input
from repro_torch.kernels.wave_replay_q.kernel import (  # noqa: F401
    launch_count, plain_count, q_weight_full_fan, reset_launch_count,
    wave_replay_q_raw)


def pad_operands_q(kp: KernelProgram, xq: torch.Tensor, wq: torch.Tensor,
                   bq: torch.Tensor, m: torch.Tensor, shift: torch.Tensor):
    """Pad int8/int32 operands to the megakernel's static geometry.

    The input pads as at fp32 (conv pad top/left, tile grid trailing,
    channel rounding) with int8 zeros; weights keep their natural
    per-group layout. Padded output channels get m=0 and shift=31, so
    their requantized lanes are exact zeros."""
    g = kp.wave.program
    l = g.layer
    pad_c = g.out_c_pad - l.out_c
    xp = pad_input(kp, xq)
    wp = F.pad(wq, (0, pad_c, 0, q_weight_full_fan(kp) - wq.shape[2]))

    def vec(v, fill=0):
        return F.pad(v.to(torch.int32), (0, pad_c),
                     value=fill).reshape(1, -1).contiguous()

    return (xp, wp.contiguous(), vec(bq), vec(m), vec(shift, 31))


def pad_residual_q(kp: KernelProgram, r: torch.Tensor) -> torch.Tensor:
    """Pad an int8 residual (B, out_h, out_w, out_c) to the kernel's
    padded output geometry (integer zeros, exact in the add)."""
    g = kp.wave.program
    return F.pad(r, (0, g.out_c_pad - g.layer.out_c,
                     0, kp.out_w_pad - kp.out_w,
                     0, kp.out_h_pad - kp.out_h)).contiguous()


def wave_replay_q_layer(kp: KernelProgram, xq: torch.Tensor,
                        wq: torch.Tensor, bq: torch.Tensor, m: torch.Tensor,
                        shift: torch.Tensor, *, pre_shift: int = 0,
                        fan_chunk: Optional[int] = None,
                        table: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Execute one streamed CONV layer as ONE int8 kernel launch.

    ``xq`` (B, in_h, in_w, in_c) int8; ``wq`` (K, K, in_c/groups, out_c)
    int8; ``bq``/``m``/``shift`` (out_c,) int32 from a ``LayerQuant``.
    Programs lowered with ``residual=True`` take the int8 shortcut
    (B, out_h, out_w, out_c) at the layer's output scale. Returns the
    valid (B, out_h, out_w, out_c) int8 output, pooled dims when the
    program fuses its pool, in the layer's output scale.
    """
    l = kp.wave.program.layer
    if table is None:
        table = torch.as_tensor(kp.operand_table(), device=xq.device)
    if kp.residual and residual is None:
        raise ValueError(f"{l.name}: program lowered with residual=True "
                         f"needs the residual operand")
    xp, wp, bqp, mp, sp = pad_operands_q(kp, xq, wq, bq, m, shift)
    rp = pad_residual_q(kp, residual) if kp.residual else None
    y = wave_replay_q_raw(kp, xp, wp, bqp, mp, sp, table,
                          pre_shift=pre_shift, fan_chunk=fan_chunk,
                          residual=rp)
    return y[:, :kp.out_h, :kp.out_w, :l.out_c]


def wave_replay_q_from_quant(kp: KernelProgram, xq: torch.Tensor, quant,
                             table: Optional[torch.Tensor] = None,
                             residual: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Convenience entry: unpack a ``LayerQuant`` (quant/calibrate.py)."""
    wq, bq, m, shift = quant.device_arrays(xq.device)
    return wave_replay_q_layer(kp, xq, wq, bq, m, shift,
                               pre_shift=quant.pre_shift,
                               fan_chunk=quant.fan_chunk, table=table,
                               residual=residual)
