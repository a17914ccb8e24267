"""Launcher and plain version of the fused int8 chain kernel K4
(``csrc/wave_replay_graph_q.cu``).

The int8 twin of ``kernels/wave_replay/graph.py``: ``wave_replay_graph_q_raw``
takes the int8 chain input padded to the head program's geometry, the
flat int8 weights and the three flat int32 vectors (bias, m, shift) that
share the table's BOFF (``pack_graph_operands_q``), checks them as the
reference launcher does (plus device, dtype and contiguity), and on a
CUDA tensor launches the hand-written kernel ONCE for the whole chain;
on a CPU tensor it runs the plain version (``wave_replay_graph_q_plain``).
There is no other route. The arena layout and node descriptors are K2's
(``launch_plan``), with K3's ``GeomQ`` per node: its static
``pre_shift`` and whether a word of A is one aligned load (``vec_x``),
decided against the slot the node reads. ``launches`` counts launches of
the CUDA kernel; ``plain_calls`` the plain version's runs on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.schedule import GraphKernelProgram
from repro_torch.kernels import _build
from repro_torch.kernels.wave_replay.graph import (SLOT_ALIGN, Stage,
                                                   _check, cached_plan,
                                                   check_offsets,
                                                   co_resident_ctas,
                                                   walk_chain)
from repro_torch.kernels.wave_replay.kernel import GEOM_FIELDS
from repro_torch.kernels.wave_replay.ops import pad_input
from repro_torch.kernels.wave_replay.ref import step_contrib
from repro_torch.kernels.wave_replay_q.kernel import (exact_channel_chunk,
                                                      q_weight_full_fan)
from repro_torch.kernels.wave_replay_q.ref import epilogue_q
from repro_torch.runtime.errors import KernelLaunchError

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


def pack_graph_operands_q(gkp: GraphKernelProgram, qops):
    """(wq, bq, m, shift) per chain node -> flat int8 (w_total,) weights
    and int32 (b_total,) bias, m and shift at the program's offsets.

    Weights keep the per-layer kernel's layout (natural per-group fan for
    grouped nodes, chain-chunk fan slices for the others); padded output
    channels carry m=0 / shift=31, so their requantized lanes are exact
    zeros, as ``pad_operands_q`` pads them.
    """
    if len(qops) != len(gkp.nodes):
        raise ValueError(f"{len(qops)} quantized operand tuples for "
                         f"{len(gkp.nodes)} chain nodes")
    dev = qops[0][0].device
    wf = torch.zeros((gkp.w_total,), dtype=torch.int8, device=dev)
    bf = torch.zeros((gkp.b_total,), dtype=torch.int32, device=dev)
    mf = torch.zeros((gkp.b_total,), dtype=torch.int32, device=dev)
    sf = torch.full((gkp.b_total,), 31, dtype=torch.int32, device=dev)
    for spec, woff, boff, (wq, bq, m, shift) in zip(
            gkp.nodes, gkp.w_offsets, gkp.b_offsets, qops):
        kp = spec.kp
        g = kp.wave.program
        l = g.layer
        wp = F.pad(wq, (0, g.out_c_pad - l.out_c,
                        0, q_weight_full_fan(kp) - wq.shape[2]))
        for kk in range(kp.n_chain):
            chunk = wp[:, :, kk * kp.fan_width:(kk + 1) * kp.fan_width, :]
            o = woff + kk * chunk.numel()
            wf[o:o + chunk.numel()] = chunk.reshape(-1)
        for flat, v in ((bf, bq), (mf, m), (sf, shift)):
            flat[boff:boff + l.out_c] = v.to(torch.int32)
    return wf, bf, mf, sf


def _check_q(gkp: GraphKernelProgram, xq, wf, bf, mf, sf, table,
             pre_shifts, fan_chunks) -> None:
    """The reference launcher's checks (``wave_replay_graph_q_raw``),
    plus device, dtype and contiguity."""
    if not gkp.quantized:
        raise ValueError("int8 graph kernel wants a program lowered with "
                         "quantized=True")
    for spec in gkp.nodes:
        kp = spec.kp
        g = kp.wave.program
        l = g.layer
        if l.groups > 1 and (kp.n_chain != 1 or g.out_c_pad != l.out_c):
            raise ValueError(
                f"{l.name}: grouped int8 kernel expects a single-step "
                f"chain over the full out_c (got n_chain={kp.n_chain}, "
                f"out_c_pad={g.out_c_pad})")
    if xq.dtype != torch.int8 or wf.dtype != torch.int8:
        raise ValueError(f"int8 graph kernel operands must be int8 (got x "
                         f"{xq.dtype}, w {wf.dtype})")
    _check(gkp, xq, [("weights", wf, torch.int8, gkp.w_total),
                     ("bias_q", bf, torch.int32, gkp.b_total),
                     ("m", mf, torch.int32, gkp.b_total),
                     ("shift", sf, torch.int32, gkp.b_total)],
           table, torch.int8)
    if len(pre_shifts) != len(gkp.nodes) \
            or len(fan_chunks) != len(gkp.nodes):
        raise ValueError("pre_shifts/fan_chunks must have one entry per "
                         "chain node")
    for spec, ps, fc in zip(gkp.nodes, pre_shifts, fan_chunks):
        if not 0 <= int(ps) <= 31:
            raise ValueError(f"{spec.name}: pre_shift {ps} outside [0, 31]")
        if fc is None:     # raises for kernels too wide, as the reference
            exact_channel_chunk(spec.kp.wave.program.layer.kernel)
        else:
            int(fc)


def wave_replay_graph_q_plain(gkp: GraphKernelProgram, xq: torch.Tensor,
                              wf: torch.Tensor, bf: torch.Tensor,
                              mf: torch.Tensor, sf: torch.Tensor,
                              table: torch.Tensor, *,
                              pre_shifts: Sequence[int]) -> torch.Tensor:
    """K4's function in plain PyTorch, on any device: the same operands
    and result as ``wave_replay_graph_q_raw``. Each chain step is K3's
    plain step (an exact float64 gemm summed in int32) and each tile its
    int32 epilogue, over int8 arena slots."""
    def step(kp, x, woff, chunk):
        l = kp.wave.program.layer
        w = wf[woff:woff + chunk].reshape(l.kernel, l.kernel,
                                          kp.fan_width, kp.out_c_pad)
        return step_contrib(kp, x.to(torch.float64),
                            w.to(torch.float64)).to(torch.int32)

    def epi(ni, kp, acc, res, boff, vr, vc):
        s = slice(boff, boff + kp.out_c_pad)
        return epilogue_q(kp, acc, bf[s], mf[s], sf[s], int(pre_shifts[ni]),
                          res, vr, vc)

    return walk_chain(gkp, xq, table, step, epi)


def _geom_q(pre_shifts, x_aligned: bool):
    """The node's ``GeomQ`` fields: K1's ``Geom``, its pre_shift, and
    ``vec_x`` when the fan, the channel stride of what the node reads and
    every step's channel origin are multiples of 4 (and, for the windowed
    head, the input's address)."""
    def fn(ni, g, in_c, origins):
        vec = (g.fan % 4 == 0 and in_c % 4 == 0
               and bool((np.asarray(origins) % 4 == 0).all())
               and (ni > 0 or x_aligned))
        return [getattr(g, f) for f in GEOM_FIELDS] + [int(pre_shifts[ni]),
                                                       int(vec)]
    return fn


def wave_replay_graph_q_raw(gkp: GraphKernelProgram, xq: torch.Tensor,
                            wf: torch.Tensor, bf: torch.Tensor,
                            mf: torch.Tensor, sf: torch.Tensor,
                            table: torch.Tensor, *, pre_shifts,
                            fan_chunks) -> torch.Tensor:
    """Run one fused int8 chain over padded operands as ONE launch.

    ``xq`` int8 pre-padded to the head program's buffer geometry; ``wf``
    flat (w_total,) int8 weights; ``bf``/``mf``/``sf`` flat (b_total,)
    int32 bias/requant-multiplier/shift sharing the BOFF offsets;
    ``pre_shifts``/``fan_chunks`` one entry per chain node (``LayerQuant``
    statics; ``fan_chunks`` is validated as the reference does, and int32
    accumulation needs no chunking). Returns the last node's padded int8
    output with masked lanes exactly 0.
    """
    global launches, plain_calls
    _check_q(gkp, xq, wf, bf, mf, sf, table, pre_shifts, fan_chunks)
    if xq.device.type == "cpu":
        plain_calls += 1
        return wave_replay_graph_q_plain(gkp, xq, wf, bf, mf, sf, table,
                                         pre_shifts=pre_shifts)
    if xq.device.type != "cuda":
        raise ValueError(f"wave_replay_graph_q runs on cuda (kernel) or "
                         f"cpu (plain version), not {xq.device}")
    B = xq.shape[0]
    kl = gkp.out_kp
    aligned = xq.data_ptr() % 4 == 0
    plan, nodes = cached_plan(
        gkp, B, xq.device,
        ("i8", tuple(int(p) for p in pre_shifts), aligned),
        _geom_q(pre_shifts, aligned))
    arena = torch.empty((plan.arena_elems,), dtype=torch.int8,
                        device=xq.device)
    out = torch.empty((B, kl.out_h_pad, kl.out_w_pad, kl.out_c_pad),
                      dtype=torch.int8, device=xq.device)
    check_offsets(xq, wf, out, arena_elems=plan.arena_elems)
    if arena.data_ptr() % 4 or SLOT_ALIGN % 4:
        raise KernelLaunchError(      # packed loads of A from a slot
            f"{gkp.nodes[0].name}: the int8 arena is not word-aligned")
    lib = _build.library("wave_replay_graph_q")
    grid = min(plan.max_ctas,
               co_resident_ctas(lib, "wave_replay_graph_q_i8_occupancy",
                                xq.device))
    fn = lib.wave_replay_graph_q_i8
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    h0 = gkp.nodes[0].kp
    stage = Stage(*plan.stage)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = fn(nodes.data_ptr(), len(gkp.nodes), ctypes.addressof(stage),
                 h0.pad_h, h0.pad_w, h0.in_c_kpad, xq.data_ptr(),
                 wf.data_ptr(), bf.data_ptr(), mf.data_ptr(), sf.data_ptr(),
                 table.data_ptr(), arena.data_ptr(), out.data_ptr(), grid,
                 stream)
    if err != 0:
        raise KernelLaunchError(
            f"{gkp.nodes[0].name}: wave_replay_graph_q_i8 cooperative "
            f"launch of {grid} CTAs failed with cudaError {err}")
    launches += 1
    return out


def wave_replay_graph_q(gkp: GraphKernelProgram, xq: torch.Tensor,
                        qops: Sequence, *, pre_shifts, fan_chunks,
                        table: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Execute a fused int8 conv chain as ONE launch.

    ``xq`` (B, in_h, in_w, in_c) int8 at the head's calibrated input
    scale; ``qops`` one (wq, bq, m, shift) tuple per chain node;
    ``pre_shifts``/``fan_chunks`` the matching ``LayerQuant`` statics.
    Returns the last node's valid int8 output, bit-identical to the
    per-layer int8 kernel run node by node.
    """
    if table is None:
        table = torch.as_tensor(gkp.operand_table(), device=xq.device)
    xp = pad_input(gkp.nodes[0].kp, xq)
    wf, bf, mf, sf = pack_graph_operands_q(gkp, qops)
    y = wave_replay_graph_q_raw(gkp, xp, wf, bf, mf, sf, table,
                                pre_shifts=pre_shifts, fan_chunks=fan_chunks)
    kl = gkp.out_kp
    return y[:, :kl.out_h, :kl.out_w, :gkp.out_layer.out_c]
