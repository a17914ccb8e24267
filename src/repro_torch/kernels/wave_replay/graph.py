"""Launcher and plain version of the fused-chain kernel K2
(``csrc/wave_replay_graph.cu``).

``wave_replay_graph_raw`` takes a chain input padded to the head
program's geometry, the flat weight and bias buffers
(``pack_graph_weights``) and the ``(total_steps, 14)`` graph table,
checks them against the ``GraphKernelProgram``, and on a CUDA tensor
launches the hand-written kernel ONCE for the whole chain on the current
stream; on a CPU tensor it runs the plain version
(``wave_replay_graph_plain``). There is no other route: a tensor on any
other device, or a launch the CUDA runtime refuses (the cooperative
grid included), raises.

The host half of the design is ``launch_plan``: the arena layout (every
slot of every image in one buffer) and one descriptor per node, K1's
``Geom`` with the slot views, built once per (program, batch, device)
and kept on the device. ``launches`` counts launches of the CUDA kernel,
one where the launch succeeds and nowhere else; ``plain_calls`` counts
the plain version's runs on CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.decomposition import _ceil_div
from repro_torch.core.schedule import (GOP_BOFF, GOP_C0, GOP_IX, GOP_IY,
                                       GOP_OX, GOP_OY, GOP_TX, GOP_TY,
                                       GOP_VC, GOP_VR, GOP_WOFF,
                                       GRAPH_OP_COLS, GraphKernelProgram,
                                       batch_grid)
from repro_torch.kernels import _build
from repro_torch.kernels.wave_replay.kernel import (GEOM_FIELDS,
                                                    launch_geometry)
from repro_torch.kernels.wave_replay.ops import pad_input
from repro_torch.kernels.wave_replay.ref import epilogue, step_contrib
from repro_torch.runtime.errors import KernelLaunchError

# The block size of csrc/wave_replay_graph.cu (and of K1's bodies).
THREADS = 256
# Slot offsets in the arena are multiples of this many elements, so an
# int8 slot whose channel stride is a multiple of 4 stays word-aligned.
SLOT_ALIGN = 16

VIEW_FIELDS = ("h", "w", "c", "dy", "dx", "wc")
# Must match ``struct Node`` in csrc/wave_replay_graph.cu after its Geom
# (and ``struct NodeQ`` in wave_replay_graph_q.cu after its GeomQ).
NODE_TAIL_FIELDS = (
    ("in_off", "in_dy", "in_dx", "in_ystep", "in_xstep", "in_cstep",
     "out_off")
    + tuple("ov_" + f for f in VIEW_FIELDS) + ("res_off",)
    + tuple("rv_" + f for f in VIEW_FIELDS)
    + ("step0", "boff", "items", "zero_elems"))
NODE_FIELDS = GEOM_FIELDS + NODE_TAIL_FIELDS
# ``struct Stage``: the chain input staged into its slot (off = -1: not).
STAGE_FIELDS = ("off", "h", "w", "c", "dy", "dx")


class Stage(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in STAGE_FIELDS]


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


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def pack_graph_weights(gkp: GraphKernelProgram, weights):
    """(w, b) per chain node -> flat (w_total,)/(b_total,) fp32 buffers.

    Per node: weights keep their natural per-group layout, pad to the
    kernel geometry, then each chain step's fan slice flattens to a
    contiguous chunk at the program's WOFF; biases pad to ``out_c_pad``
    at BOFF. Zeros everywhere else.
    """
    if len(weights) != len(gkp.nodes):
        raise ValueError(f"{len(weights)} weight pairs for "
                         f"{len(gkp.nodes)} chain nodes")
    dev = weights[0][0].device
    wf = torch.zeros((gkp.w_total,), dtype=torch.float32, device=dev)
    bf = torch.zeros((gkp.b_total,), dtype=torch.float32, device=dev)
    for spec, woff, boff, (w, b) in zip(gkp.nodes, gkp.w_offsets,
                                        gkp.b_offsets, weights):
        kp = spec.kp
        g = kp.wave.program
        l = g.layer
        wp = F.pad(w.float(), (0, g.out_c_pad - l.out_c,
                               0, kp.w_in_kpad - w.shape[2]))
        for kk in range(kp.n_chain):
            chunk = wp[:, :, kk * kp.fan_width:(kk + 1) * kp.fan_width, :]
            o = woff + kk * chunk.numel()
            wf[o:o + chunk.numel()] = chunk.reshape(-1)
        if b is not None:
            bf[boff:boff + l.out_c] = b.float()
    return wf, bf


def _check(gkp: GraphKernelProgram, x, flats, table, x_dtype) -> None:
    """The reference launcher's shape checks, plus device, dtype and
    contiguity: the kernel indexes raw pointers. ``flats`` is
    ``(name, tensor, dtype, length)`` per flat buffer."""
    h0 = gkp.nodes[0].kp
    B = x.shape[0]
    if tuple(x.shape) != (B, h0.pad_h, h0.pad_w, h0.in_c_kpad):
        raise ValueError(
            f"graph kernel input {tuple(x.shape)} != padded "
            f"({B}, {h0.pad_h}, {h0.pad_w}, {h0.in_c_kpad})")
    for name, t, dt, n in flats:
        if tuple(t.shape) != (n,):
            raise ValueError(f"flat {name} {tuple(t.shape)} != ({n},)")
    if tuple(table.shape) != (gkp.total_steps, GRAPH_OP_COLS):
        raise ValueError(
            f"graph table {tuple(table.shape)} != "
            f"({gkp.total_steps}, {GRAPH_OP_COLS})")
    named = [("x", x, x_dtype)] + [(n, t, dt) for n, t, dt, _ in flats] \
        + [("table", table, torch.int32)]
    for name, t, dt in named:
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, input on {x.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} is {t.dtype}, want {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


# ---------------------------------------------------------------------------
# the host half of the kernel: arena layout and node descriptors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """What one launch of a fused chain at one batch needs beside its
    operands: ``nodes`` (n_nodes, len(NODE_FIELDS)) int32 descriptors,
    the input ``stage``, the arena's element count and the CTAs the
    largest node's phase can use."""
    nodes: np.ndarray
    stage: Tuple[int, ...]
    arena_elems: int
    max_ctas: int


def slot_offsets(gkp: GraphKernelProgram, batch: int
                 ) -> Tuple[Tuple[int, ...], int]:
    """Element offset of every arena slot (all ``batch`` images of a slot
    side by side, NHWC), and the arena's total element count."""
    offs, total = [], 0
    for h, w, c in gkp.arena.slot_shapes:
        offs.append(total)
        total += _ceil_div(batch * h * w * c, SLOT_ALIGN) * SLOT_ALIGN
    return tuple(offs), total


def launch_plan(gkp: GraphKernelProgram, batch: int,
                geom_fn: Callable) -> LaunchPlan:
    """Descriptors for ``batch`` images. ``geom_fn(ni, geom, in_c_stride,
    channel_origins)`` returns the node's geometry fields (K1's ``Geom``
    for K2; ``GeomQ`` for K4), given K1's ``Geom`` with the input, weight
    and batch fields already set for the chain."""
    offs, total = slot_offsets(gkp, batch)
    arena = gkp.arena
    shapes = arena.slot_shapes
    last = len(gkp.nodes) - 1
    tab = gkp.operand_table()
    rows: List[List[int]] = []
    max_ctas = 1
    for ni, spec in enumerate(gkp.nodes):
        kp = spec.kp
        l = kp.wave.program.layer
        g = launch_geometry(kp, batch)
        g.w_in = kp.fan_width             # a flat chunk's fan stride
        lo = gkp.node_steps[ni]
        node_rows = tab[lo:lo + kp.n_tiles * kp.n_chain]
        cstep = kp.c_width if l.groups == 1 else 0
        if ni == 0 and not gkp.input_in_arena:
            in_off, in_dy, in_dx = -1, 0, 0
            origins = node_rows[:, GOP_C0]
        else:
            si = arena.slot_of(spec.in_value)
            iv = arena.value(spec.in_value)
            g.pad_h, g.pad_w, g.in_c = shapes[si]
            in_off, in_dy, in_dx = offs[si], iv.pad[0] - l.pad, \
                iv.pad[1] - l.pad
            origins = np.arange(kp.n_chain) * cstep
        if ni == last:
            out_off, zero = -1, 0
            ov = (kp.out_h_pad, kp.out_w_pad, kp.out_c_pad, 0, 0,
                  kp.out_c_pad)
        else:
            si = arena.slot_of(spec.out_value)
            v = arena.value(spec.out_value)
            h, w, c = shapes[si]
            out_off, zero = offs[si], batch * h * w * c
            ov = (h, w, c, v.pad[0], v.pad[1], min(kp.out_c_pad, c))
        if spec.residual_value is None:
            res_off, rv = -1, (0,) * len(VIEW_FIELDS)
        else:
            si = arena.slot_of(spec.residual_value)
            v = arena.value(spec.residual_value)
            h, w, c = shapes[si]
            res_off, rv = offs[si], (h, w, c, v.pad[0], v.pad[1], c)
        if g.depthwise:
            items = _ceil_div(batch * kp.n_tiles * kp.blk_h * kp.blk_w
                              * kp.out_c_pad, THREADS)
        else:
            items = (kp.n_tiles * g.blocks_h * g.blocks_w * g.groups
                     * g.ch_tiles * batch)
        max_ctas = max(max_ctas, items)
        ps, st = kp.pool_stride, l.stride
        rows.append(list(geom_fn(ni, g, g.in_c, origins))
                    + [in_off, in_dy, in_dx, kp.blk_h * ps * st,
                       kp.blk_w * ps * st, cstep, out_off, *ov, res_off,
                       *rv, lo, gkp.b_offsets[ni], items, zero])
    if gkp.input_in_arena:
        si = arena.slot_of(gkp.input_value)
        iv = arena.value(gkp.input_value)
        pad0 = gkp.nodes[0].kp.wave.program.layer.pad
        stage = (offs[si],) + tuple(shapes[si]) \
            + (iv.pad[0] - pad0, iv.pad[1] - pad0)
    else:
        stage = (-1, 0, 0, 0, 0, 0)
    return LaunchPlan(np.asarray(rows, np.int32), stage, total, max_ctas)


_plans: Dict[tuple, tuple] = {}
_PLANS_KEPT = 64


def cached_plan(gkp: GraphKernelProgram, batch: int, device,
                kind, geom_fn: Callable):
    """``(plan, descriptors on device)``, built once per program, batch,
    device and kernel variant (``kind``): building and uploading them
    costs more host time than a small chain's kernel. The oldest of more
    than ``_PLANS_KEPT`` entries is dropped."""
    key = (id(gkp), batch, str(device), kind)
    hit = _plans.get(key)
    if hit is None or hit[0] is not gkp:
        plan = launch_plan(gkp, batch, geom_fn)
        hit = (gkp, plan, torch.as_tensor(plan.nodes, device=device))
        _plans[key] = hit
        if len(_plans) > _PLANS_KEPT:
            _plans.pop(next(iter(_plans)))
    return hit[1], hit[2]


_occupancy: Dict[tuple, int] = {}


def co_resident_ctas(lib: ctypes.CDLL, fn_name: str, device) -> int:
    """CTAs of the kernel that can all be resident on ``device`` at once:
    its blocks per SM times the SM count. Raises when none fit."""
    key = (fn_name, str(device))
    if key not in _occupancy:
        fn = getattr(lib, fn_name)
        fn.argtypes = []
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            per_sm = fn()
        if per_sm < 1:
            raise KernelLaunchError(
                f"{fn_name}: no CTA of the cooperative kernel fits on an SM "
                f"(cudaError {-per_sm})")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _occupancy[key] = per_sm * sms
    return _occupancy[key]


def check_offsets(*tensors: torch.Tensor, arena_elems: int) -> None:
    """Raise where a buffer the kernel indexes outgrows 32-bit offsets."""
    for n in (arena_elems,) + tuple(t.numel() for t in tensors):
        if n >= 2 ** 31:
            raise ValueError(f"a buffer of {n} elements overflows the "
                             f"kernel's 32-bit offsets")


# ---------------------------------------------------------------------------
# the plain version: the flat table walked over arena slots
# ---------------------------------------------------------------------------

def walk_chain(gkp: GraphKernelProgram, xp: torch.Tensor,
               table: torch.Tensor, step_fn: Callable,
               epilogue_fn: Callable) -> torch.Tensor:
    """Walk the flat table over an arena of ``plan_arena`` slots, node
    after node, in each node's per-layer (batch block, tile, chain)
    order, so a fused chain computes exactly what the per-layer plain
    version computes node by node. ``step_fn(kp, x_window, woff,
    w_chunk)`` returns a chain step's partial sums from the flat weights
    at ``woff``; ``epilogue_fn(ni, kp, acc, residual_block, boff, vr,
    vc)`` the tile's output block. Ragged
    batches are padded with zero images to every node's whole blocks
    and cropped on return."""
    B = xp.shape[0]
    Bp = max(n * bb for n, bb in (batch_grid(B, s.kp.batch_block)
                                  for s in gkp.nodes))
    if Bp != B:
        xp = torch.cat([xp, xp.new_zeros((Bp - B,) + tuple(xp.shape[1:]))])
    arena = gkp.arena
    slots = [xp.new_zeros((Bp,) + tuple(s)) for s in arena.slot_shapes]
    if gkp.input_in_arena:
        iv = arena.value(gkp.input_value)
        h0 = gkp.nodes[0].kp
        pad0 = h0.wave.program.layer.pad
        dy, dx = iv.pad[0] - pad0, iv.pad[1] - pad0
        slots[arena.slot_of(gkp.input_value)][
            :, dy:dy + h0.pad_h, dx:dx + h0.pad_w, :h0.in_c_kpad] = xp
    tab = table.tolist()
    kl = gkp.out_kp
    out = xp.new_empty((Bp, kl.out_h_pad, kl.out_w_pad, kl.out_c_pad))
    last = len(gkp.nodes) - 1
    for ni, spec in enumerate(gkp.nodes):
        kp = spec.kp
        l = kp.wave.program.layer
        bh, bw = kp.blk_h, kp.blk_w
        lo = gkp.node_steps[ni]
        windowed = ni == 0 and not gkp.input_in_arena
        if not windowed:
            src = slots[arena.slot_of(spec.in_value)]
            iv = arena.value(spec.in_value)
            sy = kp.blk_h * kp.pool_stride * l.stride
            sx = kp.blk_w * kp.pool_stride * l.stride
        if ni != last:
            dst = slots[arena.slot_of(spec.out_value)]
            dst.zero_()
            ov = arena.value(spec.out_value)
            wc = min(kp.out_c_pad, dst.shape[-1])
        if spec.residual_value is not None:
            rsl = slots[arena.slot_of(spec.residual_value)]
            rv = arena.value(spec.residual_value)
        n_bb, bb = batch_grid(B, kp.batch_block)
        for bi in range(n_bb):
            b0 = bi * bb
            for t in range(kp.n_tiles):
                acc = None
                for k in range(kp.n_chain):
                    r = tab[lo + t * kp.n_chain + k]
                    if windowed:
                        x = xp[b0:b0 + bb, r[GOP_IY]:r[GOP_IY] + kp.ih,
                               r[GOP_IX]:r[GOP_IX] + kp.iw,
                               r[GOP_C0]:r[GOP_C0] + kp.c_width]
                    else:
                        iy = iv.pad[0] - l.pad + r[GOP_TY] * sy
                        ix = iv.pad[1] - l.pad + r[GOP_TX] * sx
                        c0 = k * kp.c_width if l.groups == 1 else 0
                        x = src[b0:b0 + bb, iy:iy + kp.ih, ix:ix + kp.iw,
                                c0:c0 + kp.c_width]
                    part = step_fn(kp, x, r[GOP_WOFF], gkp.w_chunks[ni])
                    # a zeroed accumulator, as the per-layer version sums
                    acc = (torch.zeros_like(part) if acc is None
                           else acc) + part
                ty, tx = r[GOP_TY], r[GOP_TX]
                res = None
                if spec.residual_value is not None:
                    res = rsl[b0:b0 + bb,
                              rv.pad[0] + ty * bh:rv.pad[0] + (ty + 1) * bh,
                              rv.pad[1] + tx * bw:rv.pad[1] + (tx + 1) * bw,
                              :kp.out_c_pad]
                val = epilogue_fn(ni, kp, acc, res, r[GOP_BOFF],
                                  r[GOP_VR], r[GOP_VC])
                if ni == last:
                    oy, ox = r[GOP_OY] * bh, r[GOP_OX] * bw
                    out[b0:b0 + bb, oy:oy + bh, ox:ox + bw] = val
                else:
                    y0, x0 = ov.pad[0] + ty * bh, ov.pad[1] + tx * bw
                    dst[b0:b0 + bb, y0:y0 + bh, x0:x0 + bw, :wc] = \
                        val[..., :wc]
    return out[:B]


def wave_replay_graph_plain(gkp: GraphKernelProgram, xp: torch.Tensor,
                            wf: torch.Tensor, bf: torch.Tensor,
                            table: torch.Tensor) -> torch.Tensor:
    """K2's function in plain PyTorch, on any device: the same operands
    and result as ``wave_replay_graph_raw``. Each step reuses the
    per-layer plain version's ``step_contrib`` and each tile its
    ``epilogue``, so the result equals ``wave_replay_plain`` run node by
    node."""
    def step(kp, x, woff, chunk):
        l = kp.wave.program.layer
        return step_contrib(kp, x, wf[woff:woff + chunk].reshape(
            l.kernel, l.kernel, kp.fan_width, kp.out_c_pad))

    def epi(ni, kp, acc, res, boff, vr, vc):
        return epilogue(kp, acc, bf[boff:boff + kp.out_c_pad], res, vr, vc)

    return walk_chain(gkp, xp, table, step, epi)


def wave_replay_graph_raw(gkp: GraphKernelProgram, x: torch.Tensor,
                          wf: torch.Tensor, bf: torch.Tensor,
                          table: torch.Tensor) -> torch.Tensor:
    """Run one fused chain over padded operands as ONE launch.

    ``x`` the chain input pre-padded to the head program's buffer
    geometry; ``wf``/``bf`` the flat (w_total,)/(b_total,) fp32 buffers
    at the program's offsets; ``table`` the (total_steps, 14) int32
    graph table. All contiguous on one device. Returns the last node's
    padded (B, out_h_pad, out_w_pad, out_c_pad) fp32 output; masked
    lanes are exact zeros.
    """
    global launches, plain_calls
    _check(gkp, x, [("weights", wf, torch.float32, gkp.w_total),
                    ("bias", bf, torch.float32, gkp.b_total)],
           table, torch.float32)
    if x.device.type == "cpu":
        plain_calls += 1
        return wave_replay_graph_plain(gkp, x, wf, bf, table)
    if x.device.type != "cuda":
        raise ValueError(f"wave_replay_graph runs on cuda (kernel) or cpu "
                         f"(plain version), not {x.device}")
    B = x.shape[0]
    kl = gkp.out_kp
    plan, nodes = cached_plan(gkp, B, x.device, "f32",
                              lambda ni, g, c, o: [getattr(g, f)
                                                   for f in GEOM_FIELDS])
    arena = torch.empty((plan.arena_elems,), dtype=torch.float32,
                        device=x.device)
    out = torch.empty((B, kl.out_h_pad, kl.out_w_pad, kl.out_c_pad),
                      dtype=torch.float32, device=x.device)
    check_offsets(x, wf, out, arena_elems=plan.arena_elems)
    lib = _build.library("wave_replay_graph")
    grid = min(plan.max_ctas,
               co_resident_ctas(lib, "wave_replay_graph_f32_occupancy",
                                x.device))
    fn = lib.wave_replay_graph_f32
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    h0 = gkp.nodes[0].kp
    stage = Stage(*plan.stage)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(nodes.data_ptr(), len(gkp.nodes), ctypes.addressof(stage),
                 h0.pad_h, h0.pad_w, h0.in_c_kpad, x.data_ptr(),
                 wf.data_ptr(), bf.data_ptr(), table.data_ptr(),
                 arena.data_ptr(), out.data_ptr(), grid, stream)
    if err != 0:
        raise KernelLaunchError(
            f"{gkp.nodes[0].name}: wave_replay_graph_f32 cooperative launch "
            f"of {grid} CTAs failed with cudaError {err}")
    launches += 1
    return out


def wave_replay_graph(gkp: GraphKernelProgram, x: torch.Tensor,
                      weights: Sequence,
                      table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Execute a fused conv chain as ONE launch.

    ``x`` (B, in_h, in_w, in_c) is the chain input's natural activation;
    ``weights`` a (w, b) pair per chain node in chain order; ``table``
    defaults to the program's own, uploaded to ``x``'s device. Returns
    the last node's valid (B, out_h, out_w, out_c) fp32 output, equal to
    running the per-layer kernel node by node.
    """
    if table is None:
        table = torch.as_tensor(gkp.operand_table(), device=x.device)
    xp = pad_input(gkp.nodes[0].kp, x.float())
    wf, bf = pack_graph_weights(gkp, weights)
    y = wave_replay_graph_raw(gkp, xp, wf, bf, table)
    kl = gkp.out_kp
    return y[:, :kl.out_h, :kl.out_w, :gkp.out_layer.out_c]
