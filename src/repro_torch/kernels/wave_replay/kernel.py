"""Launcher of the per-layer wave-replay megakernel (``csrc/wave_replay.cu``).

``wave_replay_raw`` takes the operands already padded to the
KernelProgram's buffer geometry, checks them against the program, and on
a CUDA tensor launches the hand-written kernel once on the current
stream; on a CPU tensor it runs the plain version
(``ref.wave_replay_plain``). There is no other route: a tensor on any
other device, or a launch the CUDA runtime refuses, raises.

``launch_geometry`` is the host half of the kernel's design: how each
TPU tile's output block is cut into CTAs (see the note in the source).

``launches`` counts launches of the hand-written kernel, one where the
launch succeeds and nowhere else; ``plain_calls`` counts the plain
version's runs on CPU tensors, which launch nothing.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.decomposition import _ceil_div
from repro_torch.core.schedule import KERNEL_OP_COLS, KernelProgram
from repro_torch.kernels import _build
from repro_torch.kernels.wave_replay.ref import wave_replay_plain
from repro_torch.runtime.errors import KernelLaunchError, LoweringError

# The CTA tile of csrc/wave_replay.cu: conv pixels x output channels.
CTA_PIXELS = 64
CTA_CHANNELS = 64

# Must match the field order of ``struct Geom`` in csrc/wave_replay.cu.
GEOM_FIELDS = (
    "batch", "pad_h", "pad_w", "in_c", "k", "stride", "w_in", "out_c",
    "fan", "groups", "opg",
    "n_chain", "n_tiles", "blk_h", "blk_w", "acc_h", "acc_w",
    "out_h_pad", "out_w_pad", "pool", "ps", "relu", "residual", "depthwise",
    "cta_ph", "cta_pw", "cta_ch", "cta_cw", "blocks_h", "blocks_w",
    "ch_tiles")


class Geom(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in GEOM_FIELDS]


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


def cta_block(kp: KernelProgram) -> "tuple[int, int]":
    """(rows, cols) of the output block one CTA writes (pooled when the
    program fuses its pool): the fewest CTAs per tile whose conv rows,
    ``(rows - 1) * ps + pool`` by ``(cols - 1) * ps + pool``, fit the
    kernel's ``CTA_PIXELS``; ties go to the smaller conv rectangle."""
    best = None
    for ph in range(1, kp.blk_h + 1):
        ch = (ph - 1) * kp.pool_stride + kp.pool
        for pw in range(1, kp.blk_w + 1):
            cw = (pw - 1) * kp.pool_stride + kp.pool
            if ch * cw > CTA_PIXELS:
                break
            key = (_ceil_div(kp.blk_h, ph) * _ceil_div(kp.blk_w, pw),
                   ch * cw)
            if best is None or key < best[0]:
                best = (key, (ph, pw))
    if best is None:
        raise LoweringError(
            f"{kp.wave.program.layer.name}: pool {kp.pool} window exceeds "
            f"the kernel's {CTA_PIXELS}-pixel CTA")
    return best[1]


def launch_geometry(kp: KernelProgram, batch: int) -> Geom:
    """The kernel's launch parameters for ``batch`` images."""
    l = kp.wave.program.layer
    depthwise = kp.groups > 1 and kp.fan_width == 1
    opg = kp.out_c_pad // kp.groups
    ph, pw = (1, 1) if depthwise else cta_block(kp)
    return Geom(
        batch=batch, pad_h=kp.pad_h, pad_w=kp.pad_w, in_c=kp.in_c_kpad,
        k=l.kernel, stride=l.stride, w_in=kp.w_in_kpad, out_c=kp.out_c_pad,
        fan=kp.fan_width, groups=kp.groups, opg=opg,
        n_chain=kp.n_chain, n_tiles=kp.n_tiles,
        blk_h=kp.blk_h, blk_w=kp.blk_w, acc_h=kp.acc_h, acc_w=kp.acc_w,
        out_h_pad=kp.out_h_pad, out_w_pad=kp.out_w_pad, pool=kp.pool,
        ps=kp.pool_stride, relu=int(kp.relu), residual=int(kp.residual),
        depthwise=int(depthwise),
        cta_ph=ph, cta_pw=pw,
        cta_ch=(ph - 1) * kp.pool_stride + kp.pool,
        cta_cw=(pw - 1) * kp.pool_stride + kp.pool,
        blocks_h=_ceil_div(kp.blk_h, ph), blocks_w=_ceil_div(kp.blk_w, pw),
        ch_tiles=_ceil_div(opg, CTA_CHANNELS))


def _check(kp: KernelProgram, x, w, b, table, residual) -> None:
    """The reference launcher's shape checks, plus device, dtype and
    contiguity: the kernel indexes raw pointers."""
    g = kp.wave.program
    l = g.layer
    B = x.shape[0]
    if tuple(x.shape) != (B, kp.pad_h, kp.pad_w, kp.in_c_kpad):
        raise ValueError(
            f"{l.name}: megakernel input {tuple(x.shape)} != padded "
            f"({B}, {kp.pad_h}, {kp.pad_w}, {kp.in_c_kpad})")
    if tuple(w.shape) != (l.kernel, l.kernel, kp.w_in_kpad, g.out_c_pad):
        raise ValueError(
            f"{l.name}: megakernel weights {tuple(w.shape)} != padded "
            f"({l.kernel}, {l.kernel}, {kp.w_in_kpad}, {g.out_c_pad})")
    if tuple(b.shape) != (1, g.out_c_pad):
        raise ValueError(f"{l.name}: bias {tuple(b.shape)} != "
                         f"(1, {g.out_c_pad})")
    if tuple(table.shape) != (kp.n_chain, kp.n_tiles, KERNEL_OP_COLS):
        raise ValueError(
            f"{l.name}: operand table {tuple(table.shape)} != "
            f"({kp.n_chain}, {kp.n_tiles}, {KERNEL_OP_COLS})")
    if kp.residual:
        want = (B, kp.out_h_pad, kp.out_w_pad, kp.out_c_pad)
        if residual is None or tuple(residual.shape) != want:
            raise ValueError(
                f"{l.name}: residual program wants a residual operand "
                f"of shape {want}, got "
                f"{None if residual is None else tuple(residual.shape)}")
    elif residual is not None:
        raise ValueError(
            f"{l.name}: program lowered without residual=True cannot "
            f"take a residual operand")
    named = [("x", x, torch.float32), ("w", w, torch.float32),
             ("bias", b, torch.float32), ("table", table, torch.int32)]
    if residual is not None:
        named.append(("residual", residual, torch.float32))
    for name, t, dt in named:
        if t.device != x.device:
            raise ValueError(f"{l.name}: {name} on {t.device}, input on "
                             f"{x.device}")
        if t.dtype != dt:
            raise ValueError(f"{l.name}: {name} is {t.dtype}, want {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{l.name}: {name} is not contiguous")


def wave_replay_raw(kp: KernelProgram, x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor, table: torch.Tensor,
                    residual: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Run one layer's megakernel over padded operands.

    ``x`` (B, pad_h, pad_w, in_c_kpad); ``w`` (K, K, w_in_kpad,
    out_c_pad); ``b`` (1, out_c_pad); ``table`` (n_chain, n_tiles, 8)
    int32; ``residual`` (B, out_h_pad, out_w_pad, out_c_pad) for programs
    lowered with ``residual=True``. All fp32 and contiguous on one device.
    Returns the padded (B, out_h_pad, out_w_pad, out_c_pad) fp32 output;
    masked lanes are exact zeros.
    """
    global launches, plain_calls
    _check(kp, x, w, b, table, residual)
    if x.device.type == "cpu":
        plain_calls += 1
        return wave_replay_plain(kp, x, w, b, table, residual)
    if x.device.type != "cuda":
        raise ValueError(f"wave_replay runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    B = x.shape[0]
    out = torch.empty((B, kp.out_h_pad, kp.out_w_pad, kp.out_c_pad),
                      dtype=torch.float32, device=x.device)
    for t in (x, w, out) + ((residual,) if residual is not None else ()):
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{kp.wave.program.layer.name}: a tensor of "
                             f"{t.numel()} elements overflows the kernel's "
                             f"32-bit offsets")
    lib = _build.library("wave_replay")
    fn = lib.wave_replay_f32
    fn.argtypes = [ctypes.c_void_p] * 8       # &geom, 6 tensors, stream
    fn.restype = ctypes.c_int
    geom = launch_geometry(kp, B)
    if B > 65535 or geom.groups * geom.ch_tiles > 65535:
        raise ValueError(f"{kp.wave.program.layer.name}: batch {B} or "
                         f"{geom.groups * geom.ch_tiles} channel tiles "
                         f"exceed the kernel's 65535-block grid axes")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(ctypes.addressof(geom), x.data_ptr(), w.data_ptr(),
                 b.data_ptr(), table.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 out.data_ptr(), stream)
    if err != 0:
        raise KernelLaunchError(
            f"{kp.wave.program.layer.name}: wave_replay_f32 launch failed "
            f"with cudaError {err}")
    launches += 1
    return out
