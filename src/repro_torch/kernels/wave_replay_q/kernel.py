"""Launcher of the int8 wave-replay megakernel (``csrc/wave_replay_q.cu``).

``wave_replay_q_raw`` takes the int8/int32 operands already padded to
the KernelProgram's buffer geometry, checks them as the reference
launcher does (plus device, dtype and contiguity), and on a CUDA tensor
launches the hand-written kernel once on the current stream; on a CPU
tensor it runs the plain version (``ref.wave_replay_q_plain``). There is
no other route: a tensor on any other device, or a launch the CUDA
runtime refuses, raises.

The kernel replays the fp32 kernel's schedule, so its CTA decomposition
is K1's ``launch_geometry``. ``launches`` counts launches of the
hand-written kernel, one where the launch succeeds and nowhere else;
``plain_calls`` counts the plain version's runs on CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.quantization import EXACT_FP32_FAN
from repro_torch.core.schedule import (KERNEL_OP_COLS, OP_C0,
                                       KernelProgram)
from repro_torch.kernels import _build
from repro_torch.kernels.wave_replay.kernel import Geom, launch_geometry
from repro_torch.kernels.wave_replay_q.ref import (  # noqa: F401
    residual_add_i8, wave_replay_q_plain)
from repro_torch.runtime.errors import KernelLaunchError

# Must match ``struct GeomQ`` in csrc/wave_replay_q.cu: K1's Geom, then
# the static pre-shift and whether input words load as aligned int32.
GEOM_Q_FIELDS = tuple(f for f, _ in Geom._fields_) + ("pre_shift", "vec_x")


class GeomQ(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in GEOM_Q_FIELDS]


launches = 0
plain_calls = 0


def launch_count() -> int:
    """Launches of the CUDA kernel since ``reset_launch_count``."""
    return launches


def plain_count() -> int:
    """Runs of the plain version on CPU tensors since
    ``reset_launch_count``."""
    return plain_calls


def reset_launch_count() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def exact_channel_chunk(kernel: int) -> int:
    """Max input channels per fp32 sub-gemm such that the gemm fan
    (K*K*channels) keeps every partial sum an exact fp32 integer."""
    c = EXACT_FP32_FAN // (kernel * kernel)
    if c < 1:
        raise ValueError(
            f"kernel {kernel}x{kernel}: a single channel's fan "
            f"{kernel * kernel} already exceeds the exact-fp32 bound "
            f"{EXACT_FP32_FAN}")
    return c


def q_weight_fan(kp: KernelProgram) -> int:
    """Weight fan-in of one chain step's int8 weight block: the
    per-group fan for grouped layers, the chain chunk for others."""
    return kp.fan_width


def q_weight_full_fan(kp: KernelProgram) -> int:
    """Fan-in of the int8 kernel's full weight operand (``w_in_kpad``,
    as at fp32)."""
    return kp.w_in_kpad


@functools.lru_cache(maxsize=128)
def _vec_words(kp: KernelProgram) -> bool:
    """Whether every four consecutive reduction elements are four
    channels of one tap at a 4-byte-aligned offset: the per-group fan,
    the channel stride and every chain step's channel origin are
    multiples of 4."""
    return (kp.fan_width % 4 == 0 and kp.in_c_kpad % 4 == 0
            and bool((kp.operand_table()[..., OP_C0] % 4 == 0).all()))


def _geometry_q(kp: KernelProgram, batch: int, pre_shift: int,
                vec_x: bool) -> GeomQ:
    g = launch_geometry(kp, batch)
    return GeomQ(*(getattr(g, f) for f, _ in Geom._fields_),
                 pre_shift, int(vec_x))


def _check(kp: KernelProgram, xq, wq, bq, m, shift, table, pre_shift,
           fan_chunk, residual) -> None:
    """The reference launcher's checks (``wave_replay_q_raw``), plus
    device and contiguity: the kernel indexes raw pointers."""
    g = kp.wave.program
    l = g.layer
    B = xq.shape[0]
    if l.groups > 1 and (kp.n_chain != 1 or g.out_c_pad != l.out_c):
        raise ValueError(
            f"{l.name}: grouped int8 kernel expects a single-step chain "
            f"over the full out_c (got n_chain={kp.n_chain}, "
            f"out_c_pad={g.out_c_pad})")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(
            f"{l.name}: int8 kernel operands must be int8 "
            f"(got x {xq.dtype}, w {wq.dtype})")
    if tuple(xq.shape) != (B, kp.pad_h, kp.pad_w, kp.in_c_kpad):
        raise ValueError(
            f"{l.name}: int8 megakernel input {tuple(xq.shape)} != padded "
            f"({B}, {kp.pad_h}, {kp.pad_w}, {kp.in_c_kpad})")
    want_w = (l.kernel, l.kernel, q_weight_full_fan(kp), g.out_c_pad)
    if tuple(wq.shape) != want_w:
        raise ValueError(f"{l.name}: int8 megakernel weights "
                         f"{tuple(wq.shape)} != {want_w}")
    for name, arr in (("bias_q", bq), ("m", m), ("shift", shift)):
        if tuple(arr.shape) != (1, g.out_c_pad) or arr.dtype != torch.int32:
            raise ValueError(
                f"{l.name}: {name} must be int32 (1, {g.out_c_pad}), "
                f"got {arr.dtype} {tuple(arr.shape)}")
    if tuple(table.shape) != (kp.n_chain, kp.n_tiles, KERNEL_OP_COLS) \
            or table.dtype != torch.int32:
        raise ValueError(
            f"{l.name}: operand table {table.dtype} {tuple(table.shape)} "
            f"!= int32 ({kp.n_chain}, {kp.n_tiles}, {KERNEL_OP_COLS})")
    if kp.residual:
        want = (B, kp.out_h_pad, kp.out_w_pad, g.out_c_pad)
        if residual is None or tuple(residual.shape) != want \
                or residual.dtype != torch.int8:
            raise ValueError(
                f"{l.name}: residual program wants an int8 residual of "
                f"shape {want}, got "
                f"{None if residual is None else tuple(residual.shape)}")
    elif residual is not None:
        raise ValueError(
            f"{l.name}: program lowered without residual=True cannot "
            f"take a residual operand")
    if not 0 <= int(pre_shift) <= 31:
        raise ValueError(f"{l.name}: pre_shift {pre_shift} outside [0, 31]")
    if fan_chunk is None:
        exact_channel_chunk(l.kernel)     # raises for kernels too wide
    else:
        int(fan_chunk)
    named = [("x", xq), ("w", wq), ("bias_q", bq), ("m", m),
             ("shift", shift), ("table", table)]
    if residual is not None:
        named.append(("residual", residual))
    for name, t in named:
        if t.device != xq.device:
            raise ValueError(f"{l.name}: {name} on {t.device}, input on "
                             f"{xq.device}")
        if not t.is_contiguous():
            raise ValueError(f"{l.name}: {name} is not contiguous")


def wave_replay_q_raw(kp: KernelProgram, xq: torch.Tensor,
                      wq: torch.Tensor, bq: torch.Tensor, m: torch.Tensor,
                      shift: torch.Tensor, table: torch.Tensor, *,
                      pre_shift: int = 0, fan_chunk: Optional[int] = None,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Run one layer's int8 megakernel over padded operands.

    ``xq`` (B, pad_h, pad_w, in_c_kpad) int8; ``wq`` (K, K, w_in_kpad,
    out_c_pad) int8 in natural per-group layout; ``bq``/``m``/``shift``
    (1, out_c_pad) int32; ``table`` the fp32 kernel's (n_chain, n_tiles,
    8) int32 table; ``residual`` (B, out_h_pad, out_w_pad, out_c_pad)
    int8 for programs lowered with ``residual=True``. ``fan_chunk`` is
    validated as the reference does; int32 accumulation is exact, so
    neither route chunks the fan. Returns the padded int8 output with
    masked lanes exactly 0.
    """
    global launches, plain_calls
    _check(kp, xq, wq, bq, m, shift, table, pre_shift, fan_chunk, residual)
    if xq.device.type == "cpu":
        plain_calls += 1
        return wave_replay_q_plain(kp, xq, wq, bq, m, shift, table,
                                   pre_shift=int(pre_shift),
                                   residual=residual)
    if xq.device.type != "cuda":
        raise ValueError(f"wave_replay_q runs on cuda (kernel) or cpu "
                         f"(plain version), not {xq.device}")
    B = xq.shape[0]
    name = kp.wave.program.layer.name
    out = torch.empty((B, kp.out_h_pad, kp.out_w_pad, kp.out_c_pad),
                      dtype=torch.int8, device=xq.device)
    for t in (xq, wq, out) + ((residual,) if residual is not None else ()):
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: a tensor of {t.numel()} elements "
                             f"overflows the kernel's 32-bit offsets")
    geom = _geometry_q(kp, B, int(pre_shift),
                       _vec_words(kp) and xq.data_ptr() % 4 == 0)
    if B > 65535 or geom.groups * geom.ch_tiles > 65535:
        raise ValueError(f"{name}: batch {B} or "
                         f"{geom.groups * geom.ch_tiles} channel tiles "
                         f"exceed the kernel's 65535-block grid axes")
    fn = _build.library("wave_replay_q").wave_replay_q_i8
    fn.argtypes = [ctypes.c_void_p] * 10      # &geom, 8 tensors, stream
    fn.restype = ctypes.c_int
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = fn(ctypes.addressof(geom), xq.data_ptr(), wq.data_ptr(),
                 bq.data_ptr(), m.data_ptr(), shift.data_ptr(),
                 table.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 out.data_ptr(), stream)
    if err != 0:
        raise KernelLaunchError(
            f"{name}: wave_replay_q_i8 launch failed with cudaError {err}")
    launches += 1
    return out
