"""Streaming graph executor, megakernel mode (paper §3 + §5 combined).

The counterpart of ``repro/core/streaming.py`` for the fp32 megakernel
graph path: every conv node of a ``NetworkGraph`` is planned
(``plan_graph``), lowered to a ``TileProgram`` (``compile_graph``) and
then to a ``KernelProgram`` re-planned at the kernel's budget point
(``graph_kernel_programs``), and the forward walks the validated
topological schedule with ONE launch of the wave-replay kernel per conv
node (kernels/wave_replay). Residual adds that ``residual_fusion``
selects run in the producing conv's kernel epilogue; the others run as
explicit elementwise adds. Activations are dropped per the graph's
liveness plan the moment their last consumer has fired.

``conv2d_direct`` / ``maxpool_direct`` / ``run_graph_reference`` are the
direct (undecomposed) reference the executor is tested against: NHWC
activations and HWIO weights at the boundary, ``F.conv2d`` inside.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.decomposition import (ConvLayer, Plan, evaluate,
                                            plan_decomposition)
from repro_torch.core.graph import (INPUT, NetworkGraph, check_graph_input,
                                    conv_keyed, plan_buffers,
                                    residual_fusion, topological_schedule)
from repro_torch.core.schedule import (DEFAULT_VMEM_BUDGET as _VMEM_DEFAULT,
                                       KernelProgram, TileProgram,
                                       compile_layer, lower_kernel_program,
                                       partition_waves)
from repro_torch.runtime.errors import PlanError

# Executor modes of the reference that this package does not run yet,
# each with the ROADMAP item that ports it.
_NOT_PORTED = {
    "wave": "queue 1 item 2 (layer executors without custom kernels)",
    "scan": "queue 1 item 2 (layer executors without custom kernels)",
    "jit": "queue 1 item 2 (layer executors without custom kernels)",
    "interpret": "queue 1 item 2 (layer executors without custom kernels)",
    "graphkernel": "queue 1 item 6 (whole-graph mode, kernel K2)",
}


def check_mode(mode: str, precision: str = "fp32") -> None:
    """Raise for an executor mode or precision this package cannot run."""
    if precision == "int8":
        raise NotImplementedError(
            "precision='int8' is not ported yet: ROADMAP queue 1 item 5 "
            "(quantized datapath, kernel K3)")
    if precision != "fp32":
        raise ValueError(f"unknown precision {precision!r} "
                         f"(expected fp32 | int8)")
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet: ROADMAP {_NOT_PORTED[mode]}")
    if mode != "megakernel":
        raise ValueError(f"unknown executor mode {mode!r} (expected "
                         f"megakernel | graphkernel | wave | scan/jit | "
                         f"interpret)")


def conv2d_direct(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  pad: int = 0, groups: int = 1) -> torch.Tensor:
    """x (B,H,W,Cin), w (K,K,Cin/groups,Cout) -> (B,Ho,Wo,Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1)


def maxpool_direct(x: torch.Tensor, window: int,
                   stride: int = 0) -> torch.Tensor:
    """VALID max-pool over (B,H,W,C)."""
    stride = stride or window
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


# both lowerings are pure on hashable frozen inputs; memoizing them means
# the forward builder, its operand tables and the re-planner share one
# lowering + validation per program
_partition_waves_cached = functools.lru_cache(maxsize=128)(partition_waves)
_lower_kernel_cached = functools.lru_cache(maxsize=128)(lower_kernel_program)


def plan_graph(graph: NetworkGraph,
               sram_budget: int = 128 * 1024) -> "OrderedDict[str, Plan]":
    """Plan every conv node's decomposition under one buffer budget."""
    return OrderedDict((n.name, plan_decomposition(n.layer, sram_budget))
                       for n in graph.conv_nodes())


def compile_graph(graph: NetworkGraph,
                  plans) -> "OrderedDict[str, TileProgram]":
    """Lower every conv node's Plan to its TileProgram, keyed by node."""
    plans = conv_keyed(graph, plans, "plans")
    return OrderedDict((name, compile_layer(graph.node(name).layer, p))
                       for name, p in plans.items())


def _graph_epilogues(graph: NetworkGraph):
    """Per conv node: (epilogue_relu, residual_value | None, out_value).

    Residual-fused convs take the add's ReLU as their epilogue ReLU and
    produce the ADD's value (the add node itself is skipped); all other
    convs keep their own flags.
    """
    rf = residual_fusion(graph)
    conv_res = rf.conv_residual()
    add_of = rf.add_of_conv()
    by_name = {n.name: n for n in graph.nodes}
    out = {}
    for n in graph.conv_nodes():
        if n.name in conv_res:
            add = by_name[add_of[n.name]]
            out[n.name] = (add.relu, conv_res[n.name], add.name)
        else:
            out[n.name] = (n.relu, None, n.name)
    return out


def _graph_kernel_program(program: TileProgram, relu: bool,
                          residual: bool,
                          vmem_budget: Optional[int],
                          batch: int = 1) -> KernelProgram:
    """Megakernel lowering for one graph conv node: the node's ReLU (or
    its fused add's) in the epilogue, the layer's pool fused when it has
    one, the residual operand when an add folds in, and the schedule
    re-planned at the kernel's budget point (``plan_for_vmem``; ``None``
    replays the given program 1:1)."""
    l = program.layer
    fuse = l.pool > 1
    if vmem_budget is None:
        return _lower_kernel_cached(_partition_waves_cached(program),
                                    relu=relu, fuse_pool=fuse,
                                    residual=residual, vmem_budget=None,
                                    batch_block=batch)
    plan = plan_for_vmem(l, vmem_budget, fuse, residual=residual,
                         batch=batch)
    return _lower_kernel_cached(
        _partition_waves_cached(compile_layer(l, plan)),
        relu=relu, fuse_pool=fuse, residual=residual,
        vmem_budget=vmem_budget, batch_block=batch)


def graph_kernel_programs(
        graph: NetworkGraph, programs,
        vmem_budget: Optional[int] = _VMEM_DEFAULT,
        batch: int = 1) -> "OrderedDict[str, KernelProgram]":
    """The megakernel lowering of a whole graph, exactly as the graph
    forward replays it (per-node epilogue ReLU, fused pools, residual
    operands, budget re-planning)."""
    programs = conv_keyed(graph, programs, "programs")
    epi = _graph_epilogues(graph)
    return OrderedDict(
        (name, _graph_kernel_program(p, epi[name][0],
                                     epi[name][1] is not None,
                                     vmem_budget, batch))
        for name, p in programs.items())


def graph_operands(graph: NetworkGraph, programs,
                   mode: str = "megakernel",
                   vmem_budget: Optional[int] = _VMEM_DEFAULT,
                   precision: str = "fp32", batch: int = 1,
                   device="cuda") -> "OrderedDict[str, torch.Tensor]":
    """Per-conv-node ``(n_chain, n_tiles, 8)`` int32 operand tables on
    ``device``, matching ``graph_forward_fn``. Pass the same ``batch``
    as the forward builder."""
    check_mode(mode, precision)
    return OrderedDict(
        (name, torch.as_tensor(kp.operand_table(), device=device))
        for name, kp in graph_kernel_programs(
            graph, programs, vmem_budget, batch).items())


def graph_forward_fn(graph: NetworkGraph, programs,
                     mode: str = "megakernel",
                     vmem_budget: Optional[int] = _VMEM_DEFAULT,
                     precision: str = "fp32",
                     batch: int = 1) -> Callable:
    """Whole-graph forward over pre-lowered programs.

    Returns ``f(x, weights, ops) -> y`` where ``weights`` maps conv node
    name -> (w, b) and ``ops`` maps node name -> operand table
    (``graph_operands``). Each conv node is one wave-replay launch;
    residual adds fold into the producing conv's epilogue where
    ``residual_fusion`` allows, and run as explicit adds elsewhere.
    """
    from repro_torch.kernels.wave_replay.ops import wave_replay_layer
    check_mode(mode, precision)
    programs = conv_keyed(graph, programs, "programs")
    sched = topological_schedule(graph)
    bplan = plan_buffers(graph)
    epi = _graph_epilogues(graph)
    kprogs = graph_kernel_programs(graph, programs, vmem_budget, batch)
    fused_adds = {outv for _, resv, outv in epi.values() if resv is not None}

    def forward_mega(x, weights, ops):
        check_graph_input(graph, x)
        env = {INPUT: x}
        for i, n in enumerate(sched):
            if n.op == "conv":
                _, resv, outv = epi[n.name]
                w, b = weights[n.name]
                env[outv] = wave_replay_layer(
                    kprogs[n.name], env[n.inputs[0]], w, b,
                    table=ops[n.name],
                    residual=env[resv] if resv is not None else None)
            elif n.name not in fused_adds:
                y = env[n.inputs[0]] + env[n.inputs[1]]
                env[n.name] = torch.relu(y) if n.relu else y
            for v in bplan.frees[i]:            # liveness: drop dead refs
                env.pop(v, None)
        return env[graph.output]

    return forward_mega


def run_graph_reference(graph: NetworkGraph, weights,
                        x: torch.Tensor) -> "OrderedDict[str, torch.Tensor]":
    """Direct (undecomposed) reference forward over the graph schedule,
    returning EVERY value (``"input"`` included): each conv value is
    post-bias/ReLU/pool, each add value post-ReLU."""
    check_graph_input(graph, x)
    weights = conv_keyed(graph, weights, "weights")
    env = OrderedDict({INPUT: x})
    for n in topological_schedule(graph):
        if n.op == "conv":
            l = n.layer
            w, b = weights[n.name]
            y = conv2d_direct(env[n.inputs[0]], w.to(x.dtype),
                              l.stride, l.pad, groups=l.groups)
            if b is not None:
                y = y + b.to(x.dtype)
            if n.relu:
                y = torch.relu(y)
            if l.pool > 1:
                y = maxpool_direct(y, l.pool, l.pool_stride or l.pool)
        else:
            y = env[n.inputs[0]] + env[n.inputs[1]]
            if n.relu:
                y = torch.relu(y)
        env[n.name] = y
    return env


@functools.lru_cache(maxsize=128)
def plan_for_vmem(layer: ConvLayer,
                  vmem_budget: int = _VMEM_DEFAULT,
                  fuse_pool: bool = False,
                  max_tiles: int = 8,
                  residual: bool = False,
                  batch: int = 1) -> Plan:
    """Re-plan a layer's decomposition at the megakernel's budget point.

    The fewest (tile x chain) grid steps whose fp32 working set
    (``KernelProgram.vmem_bytes``) fits, ties broken toward the smaller
    working set; when nothing fits, the over-budget candidate with the
    fewest steps wins. Feature splits stay at 1. ``batch`` scores the
    TOTAL grid steps for the whole batch — ``ceil(batch / batch_block) *
    tiles * chain``. The same search as the reference, so both packages
    replay the same programs.
    """
    best = None          # ((over_budget, grid_steps, ws), plan)
    in_choices = sorted({1, 2, 4, 8, 16, 32, 64, 128, layer.in_c})
    for th in range(1, max_tiles + 1):
        for tw in range(1, max_tiles + 1):
            for cs in in_choices:
                if cs > layer.in_c:
                    continue
                p = evaluate(layer, th, tw, 1, cs)
                if p is None:
                    continue
                kp = _lower_kernel_cached(
                    _partition_waves_cached(compile_layer(layer, p)),
                    relu=True, fuse_pool=fuse_pool, residual=residual,
                    vmem_budget=None if batch == 1 else vmem_budget,
                    batch_block=batch)
                ws = kp.vmem_bytes
                n_bb = -(-batch // kp.batch_block)
                key = (ws > vmem_budget,
                       n_bb * kp.n_tiles * kp.n_chain, ws)
                if best is None or key < best[0]:
                    best = (key, p)
    if best is None:
        raise PlanError(f"{layer.name}: no feasible megakernel plan")
    return best[1]
