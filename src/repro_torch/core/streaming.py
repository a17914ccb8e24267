"""Streaming graph executor, megakernel and whole-graph modes (paper §3
+ §5 combined).

The counterpart of ``repro/core/streaming.py`` for the megakernel graph
path at fp32 (kernel K1) and int8 (kernel K3, the same tables): every
conv node of a ``NetworkGraph`` is planned (``plan_graph``), lowered to a
``TileProgram`` (``compile_graph``) and then to a ``KernelProgram``
re-planned at the kernel's budget point (``graph_kernel_programs``), and
the forward walks the validated topological schedule with ONE launch of
the wave-replay kernel per conv node (kernels/wave_replay and
kernels/wave_replay_q). Residual adds that ``residual_fusion``
selects run in the producing conv's kernel epilogue; the others run as
explicit elementwise adds. Activations are dropped per the graph's
liveness plan the moment their last consumer has fired.

``mode="graphkernel"`` partitions the conv schedule into fused chains
(``graph_chain_programs``) and runs each multi-node chain as ONE launch
of the whole-chain kernel (K2 at fp32, K4 at int8,
``kernels/wave_replay{,_q}/graph.py``); a single-node chain falls back
to the per-layer launch.

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
                                    conv_keyed, fusible_chains, plan_buffers,
                                    residual_fusion, topological_schedule)
from repro_torch.core.schedule import (DEFAULT_VMEM_BUDGET as _VMEM_DEFAULT,
                                       ChainNodeSpec, KernelProgram,
                                       TileProgram, chain_vmem_bytes,
                                       compile_layer, lower_graph_kernel,
                                       lower_kernel_program, partition_waves)
from repro_torch.runtime.errors import PlanError

# Executor modes of the reference that this package does not run yet,
# each with the ROADMAP item that ports it.
_NOT_PORTED = {
    "wave": "queue 1 item 2 (layer executors without custom kernels)",
    "scan": "queue 1 item 2 (layer executors without custom kernels)",
    "jit": "queue 1 item 2 (layer executors without custom kernels)",
    "interpret": "queue 1 item 2 (layer executors without custom kernels)",
}


def check_mode(mode: str, precision: str = "fp32") -> None:
    """Raise for an executor mode or precision this package cannot run."""
    if precision not in ("fp32", "int8"):
        raise ValueError(f"unknown precision {precision!r} "
                         f"(expected fp32 | int8)")
    if precision == "int8" and mode not in ("megakernel", "graphkernel"):
        raise ValueError(
            "precision='int8' runs on the quantized megakernel only: "
            "pass mode='megakernel' or mode='graphkernel'")
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet: ROADMAP {_NOT_PORTED[mode]}")
    if mode not in ("megakernel", "graphkernel"):
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


def graph_chain_programs(graph: NetworkGraph, programs,
                         vmem_budget: Optional[int] = _VMEM_DEFAULT,
                         quantized: bool = False,
                         batch: int = 1):
    """Partition a graph into fused chains and lower each multi-node
    chain to its whole-chain ``GraphKernelProgram``.

    Returns ``(chains, kprogs, gkps)``: the ``FusedChain`` partition in
    schedule order, the per-node ``KernelProgram`` map (single-node
    chains fall back to these per-layer launches), and the
    ``GraphKernelProgram`` per multi-node chain keyed by its HEAD conv
    name. Deterministic for a (graph, programs, budget, precision,
    batch) tuple, so operand tables and the forward derive the
    identical partition independently.

    Chain membership is decided at the per-image footprint (a chain
    valid at one image per step stays fusible at any batch); each
    chain is lowered with the largest per-step image block whose
    whole-chain arena and accumulator fit the budget, as the reference
    lowers it.
    """
    programs = conv_keyed(graph, programs, "programs")
    kprogs = graph_kernel_programs(graph, programs, vmem_budget, batch)
    chains = fusible_chains(graph, kprogs, vmem_budget=vmem_budget,
                            quantized=quantized)
    epi = _graph_epilogues(graph)
    by_name = {n.name: n for n in graph.nodes}
    gkps = {}
    for c in chains:
        if len(c.convs) < 2:
            continue
        specs = [ChainNodeSpec(name=name, kp=kprogs[name],
                               in_value=by_name[name].inputs[0],
                               out_value=epi[name][2],
                               residual_value=epi[name][1])
                 for name in c.convs]
        gkps[c.convs[0]] = lower_graph_kernel(
            specs, quantized=quantized,
            batch_block=_chain_batch_block(specs, quantized, vmem_budget,
                                           batch))
    return chains, kprogs, gkps


def _chain_batch_block(specs, quantized: bool,
                       vmem_budget: Optional[int], batch: int) -> int:
    """Largest images-per-step block whose whole-chain footprint (arena
    slots + accumulator + input/output blocks, all per image) fits
    ``vmem_budget``. ``chain_vmem_bytes`` is affine in the block size
    (weights and bias are batch-shared), so the bound solves in two
    evaluations. ``None`` budget takes the full batch."""
    bb = max(1, int(batch))
    if vmem_budget is None or bb == 1:
        return bb
    b1 = chain_vmem_bytes(specs, quantized=quantized, batch_block=1)
    per = chain_vmem_bytes(specs, quantized=quantized, batch_block=2) - b1
    if per <= 0:
        return bb
    fit = (vmem_budget - (b1 - per)) // per
    return max(1, min(bb, int(fit)))


def graph_operands(graph: NetworkGraph, programs,
                   mode: str = "megakernel",
                   vmem_budget: Optional[int] = _VMEM_DEFAULT,
                   precision: str = "fp32", batch: int = 1,
                   device="cuda") -> "OrderedDict[str, torch.Tensor]":
    """Operand tables on ``device`` matching ``graph_forward_fn``: per
    conv node the ``(n_chain, n_tiles, 8)`` int32 table in megakernel
    mode; in graphkernel mode one table per fused chain, keyed by its
    head conv, ``(total_steps, 14)`` for a multi-node chain and the
    per-layer table for a single-node one. Pass the same ``batch`` as
    the forward builder."""
    check_mode(mode, precision)
    if mode == "graphkernel":
        chains, kprogs, gkps = graph_chain_programs(
            graph, programs, vmem_budget,
            quantized=precision == "int8", batch=batch)
        return OrderedDict(
            (c.convs[0], torch.as_tensor(
                gkps[c.convs[0]].operand_table() if c.convs[0] in gkps
                else kprogs[c.convs[0]].operand_table(), device=device))
            for c in chains)
    return OrderedDict(
        (name, torch.as_tensor(kp.operand_table(), device=device))
        for name, kp in graph_kernel_programs(
            graph, programs, vmem_budget, batch).items())


def graph_forward_fn(graph: NetworkGraph, programs,
                     mode: str = "megakernel",
                     vmem_budget: Optional[int] = _VMEM_DEFAULT,
                     precision: str = "fp32", qgraph=None,
                     dequantize: bool = True,
                     batch: int = 1) -> Callable:
    """Whole-graph forward over pre-lowered programs.

    Returns ``f(x, weights, ops) -> y`` where ``weights`` maps conv node
    name -> (w, b) and ``ops`` maps node (or chain head) name -> operand
    table (``graph_operands``). In megakernel mode each conv node is one
    wave-replay launch; in graphkernel mode each multi-node fused chain
    is one whole-chain launch at its head and its other nodes are
    skipped, while a single-node chain takes the per-layer launch.
    Residual adds fold into the producing conv's epilogue where
    ``residual_fusion`` allows, and run as explicit adds elsewhere.

    ``precision="int8"`` walks the same schedule and replays the same
    tables on the fixed-point datapath (kernels K3 and K4) over a
    calibrated ``qgraph`` (``quant.calibrate.QuantizedGraph``):
    ``weights`` are ``qgraph.device_weights(device)``, a float input is
    quantized at the input's scale (an int8 one is taken as codes), raw
    int8 flows along every edge, and residual adds are int32 adds with a
    clip. ``dequantize=False`` returns the raw int8 output.
    """
    check_mode(mode, precision)
    programs = conv_keyed(graph, programs, "programs")
    sched = topological_schedule(graph)
    bplan = plan_buffers(graph)
    epi = _graph_epilogues(graph)
    if mode == "graphkernel":
        chains, kprogs, gkps = graph_chain_programs(
            graph, programs, vmem_budget, quantized=precision == "int8",
            batch=batch)
        chain_of = {c.convs[0]: c for c in chains}
        members = {name for c in chains for name in c.convs[1:]}
    else:
        kprogs = graph_kernel_programs(graph, programs, vmem_budget, batch)
        chain_of, members, gkps = {}, set(), {}
    fused_adds = {outv for _, resv, outv in epi.values() if resv is not None}

    if precision == "int8":
        if qgraph is None:
            raise ValueError(
                "precision='int8' needs a calibrated QuantizedGraph: run "
                "repro_torch.quant.calibrate.calibrate_graph first")
        from repro_torch.core.quantization import (dequantize_int8,
                                                   quantize_int8_sym)
        from repro_torch.kernels.wave_replay_q.graph import \
            wave_replay_graph_q
        from repro_torch.kernels.wave_replay_q.kernel import \
            residual_add_i8
        from repro_torch.kernels.wave_replay_q.ops import \
            wave_replay_q_layer
        statics = {name: (qgraph.quants[name].pre_shift,
                          qgraph.quants[name].fan_chunk)
                   for name in kprogs}
        in_scale = float(qgraph.scales[INPUT])
        out_scale = float(qgraph.scales[graph.output])

        def forward_q(x, weights, ops):
            check_graph_input(graph, x)
            env = {INPUT: x if x.dtype == torch.int8
                   else quantize_int8_sym(x, in_scale)}
            for i, n in enumerate(sched):
                if n.op == "conv":
                    if n.name in members:
                        pass                # ran inside its chain's launch
                    elif n.name in gkps:    # a multi-node fused chain
                        c = chain_of[n.name]
                        env[c.output_value] = wave_replay_graph_q(
                            gkps[n.name], env[c.input_value],
                            [weights[m] for m in c.convs],
                            pre_shifts=[statics[m][0] for m in c.convs],
                            fan_chunks=[statics[m][1] for m in c.convs],
                            table=ops[n.name])
                    else:
                        _, resv, outv = epi[n.name]
                        wq, bq, m, s = weights[n.name]
                        ps, fc = statics[n.name]
                        env[outv] = wave_replay_q_layer(
                            kprogs[n.name], env[n.inputs[0]], wq, bq, m, s,
                            pre_shift=ps, fan_chunk=fc, table=ops[n.name],
                            residual=env[resv] if resv is not None
                            else None)
                elif n.name not in fused_adds:
                    env[n.name] = residual_add_i8(
                        env[n.inputs[0]], env[n.inputs[1]], n.relu)
                for v in bplan.frees[i]:        # liveness: drop dead refs
                    env.pop(v, None)
            y = env[graph.output]
            return dequantize_int8(y, out_scale) if dequantize else y

        return forward_q

    from repro_torch.kernels.wave_replay.graph import wave_replay_graph
    from repro_torch.kernels.wave_replay.ops import wave_replay_layer

    def forward_mega(x, weights, ops):
        check_graph_input(graph, x)
        env = {INPUT: x}
        for i, n in enumerate(sched):
            if n.op == "conv":
                if n.name in members:
                    pass                    # ran inside its chain's launch
                elif n.name in gkps:        # a multi-node fused chain
                    c = chain_of[n.name]
                    env[c.output_value] = wave_replay_graph(
                        gkps[n.name], env[c.input_value],
                        [weights[m] for m in c.convs], table=ops[n.name])
                else:
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
