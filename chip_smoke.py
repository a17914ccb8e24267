#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``card``: the card's name and power limit (``nvidia-smi``), and what
   PyTorch sees.
2. ``build``: compile the port's kernel sources with ``nvcc``, one
   process per source, all started together (``-Xptxas -v`` report
   included), and time it.
3. ``kernel``: hold the fp32 wave-replay kernel (K1) against its plain
   PyTorch version on the same CUDA tensors, one phase per branch:
   AlexNet's five layers at 227x227 and batch 8 (dense, grouped, fused
   3/2 pool), a residual node of ResNet-18, a depthwise node of
   MobileNet-v1, a depthwise layer with a channel multiplier, and a
   ``vmem_budget=None`` layer with a multi-tile grid and a multi-step
   chain.
4. ``kernel_q``: hold the int8 wave-replay kernel (K3) bit for bit
   (``torch.equal``) against its plain version on the same five cases,
   over random int8 operands and requantize vectors from
   ``requant_params``; report the shares of outputs at 0 and at +-127.
5. ``kernel_g``: hold the fused-chain kernel (K2) against its plain
   version on the same CUDA tensors (to ``FP32_TOL``) and against K1
   walked node by node (``torch.equal``: K2 runs K1's bodies with K1's
   CTA split), per chain: AlexNet's two chains at the default budget
   and batch 8, the whole network as one chain at 16 MB, the 281-step
   chain of the 64 KB plans replayed 1:1 at batch 2, an identity block
   whose residual is read from an arena slot, a block whose input is
   staged into the arena, and MobileNet-v1's 27-node depthwise chain.
6. ``kernel_gq``: hold the int8 fused-chain kernel (K4) bit for bit
   against its plain version and against K3 walked node by node, on the
   same chains.
7. ``quant``: entry quantization on the card equals it on the CPU at
   exact halves of the scale.
8. ``serve``: serve 32 AlexNet requests at batch 8 through the port's
   fp32 ``StreamingSession`` on the card, with the launch counts set to 0
   just before and read just after; the outputs are held against the
   port's direct reference on the card (TF32 off for matmul and cuDNN).
9. ``serve_q``: calibrate AlexNet on the card, serve the same 32 requests
   through the int8 session (K3 five times per batched call, K1 never),
   hold its raw int8 output bit for bit against the port's int32
   reference walk on the card, and report the SNR of the dequantized
   output against the fp32 reference.
10. ``serve_g``: the same 32 requests through the fp32 session in
    whole-graph mode (``mode="graphkernel"``): K2 twice per batched call
    (conv1+conv2, conv3-conv5), K1 never; the output equals the
    megakernel session's (``torch.equal``) and is held against the
    direct reference.
11. ``serve_gq``: the int8 twin: K4 twice per call, K3 never; the raw
    output equals the int32 reference walk and the megakernel session's
    raw output; the SNR is reported.
12. ``kernel_cs``: hold the streaming conv kernel (K6) against its plain
    version on the same CUDA tensors (to ``FP32_TOL``), on the operands
    the wave and scan executors hand it in one AlexNet forward (captured
    by running each node's executor with a recording conv_fn: the first,
    a middle and the last call of every node, as views: conv1's stacked
    windows at stride 4 and K 11, conv3's one-channel slices, every scan
    step's window and weight chunk) and on shapes of no AlexNet node (Cin
    130, K 5 at stride 2, K 1, a transposed view the launcher copies).
13. ``kernel_fcp``: hold the fused conv + ReLU + pool kernel (K5)
    against its plain version on AlexNet conv1, conv2 and conv5 at batch
    8 (stride 4; pad 2 and two groups; pad 1 and two groups; 3/2 pools),
    a 2/2 pool, a 3/3 pool with two groups, and pooled rows that do not
    fill the plain version's last row block.
14. ``kernel_mp``: the streaming max-pool kernel (K7) through its public
    op ``maxpool_stream``, one launch per call (every kernel's count set
    to 0 before each call and read after), equal (``torch.equal``, a NaN
    matching a NaN) to its plain version on the same CUDA tensors and to
    ``maxpool_ref`` wherever the reference's -inf start and the kernel's
    -3e38 agree: AlexNet's three 3/2 pools at batch 8, the reference
    test's five cases, a ragged 2/2 pool, stride > pool, bf16, and an
    input holding NaN and -inf.
15. ``kernel_qmm``: the int8 matmul kernel (K8) through ``quant_matmul``,
    one launch per call, ``torch.equal`` to ``quant_matmul_ref`` and its
    plain version, and at unit scales to the float64 accumulator: AlexNet's
    int8 gemms at batch 8 (conv3's and conv2's im2col, the head's two
    layers), the reference test's four blockings, M 1, qmin/qmax at K
    512; then ``quantize_activations``/``quantize_weights`` on the card
    equal them on the CPU at exact halves of the scale.
16. ``kernel_fa``: the flash-attention kernel (K9) through
    ``flash_attention``, one launch per call, against its plain version
    and ``attention_ref`` (TF32 off) to 2e-5 (fp32) and 2e-2 (bf16), and
    a bf16 result besides to one bf16 ULP of both and half a ULP of the
    fp32 attention of its inputs: a Qwen3-1.7B layer at prefill (H 16,
    KV 8, D 128, S = T = 4096, causal) in fp32 and bf16, a Gemma3-4B
    local layer at the repo config's widths (H 8, KV 4, window 1024, D
    320 = d_model / n_heads; the published head_dim is 256), the
    reference test's five cases and its dtype case, S not divisible by
    the block, and T != S without causal.
17. ``serve_w``: the same 32 requests through the session in wave mode
    with (``conv_backend``, ``pool_backend``) = (xla, xla), (pallas,
    xla), (pallas, fused): 0 / 257 / 256 K6 and 0 / 0 / 3 K5 launches
    per batched call, no other kernel; outputs within ``FP32_TOL`` of the
    direct reference, the (xla, xla) one also with cuDNN's TF32 allowed
    by the process (the direct conv turns it off for itself).
18. ``serve_s``: the same in scan mode: 0 / 1142 / 1072 K6 and 0 / 0 / 3
    K5 launches per call. No serving run launches K7, K8 or K9.
19. ``timing``: per AlexNet layer at batch 8, each per-layer kernel's
    median time, its plain version's, a library yardstick the port never
    calls (``library_ms``: cuDNN's ``conv2d + bias + ReLU + max_pool2d``
    for K1, ``torch._int_mm`` on the layer's im2col, per group, gemm
    only, for K3) and the bound; per AlexNet chain the same for K2 and
    K4 (bound and ``library_ms`` summed over the chain's layers); per
    AlexNet forward the same for K6 (the wave path's 257 calls and the
    scan path's 1072, replayed; cuDNN's conv per call as the yardstick)
    and K5 (conv1, conv2, conv5; cuDNN's conv + bias + ReLU +
    ``max_pool2d``), with the profiler's device time beside the CUDA
    events'; per public-op call the same for K7 (AlexNet's pools;
    ``F.max_pool2d``), K8 (AlexNet's gemms; ``torch._int_mm`` and the two
    scale multiplies) and K9 (the Qwen3 and Gemma3 layers;
    ``F.scaled_dot_product_attention``), each with its launches per AlexNet
    forward on the serving paths (0); for each precision and mode, and the
    wave and scan configurations, the served images per second over
    windows of at least a second and, from ``torch.profiler`` over served
    runs, the device time by kernel, the device's idle share and the host
    time by operation.

Then the ``nvidia-smi`` line, the ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Any failure exits nonzero before the
``ok`` line. Weights and inputs are random, from fixed seeds.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BATCH = 8
REQUESTS = 32
PREFILL = 4096          # S = T of the attention layers of phase kernel_fa

# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): fp32
# outside the tensor cores, dense bf16 and int8 on the tensor cores, and
# memory bandwidth.
H100_SXM = "H100 80GB HBM3"
FP32_PEAK_FLOPS = 67.0e12
BF16_PEAK_FLOPS = 989.0e12
INT8_PEAK_OPS = 1979.0e12
MEM_BYTES_PER_S = 3.35e12
SERVE_WINDOW_S = 1.0    # each served-rate window lasts at least this long
SERVE_WINDOWS = 3


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def peaks_for(name: str):
    if H100_SXM not in name:
        raise RuntimeError(f"the bounds use the H100 SXM's peaks; this "
                           f"card is {name!r}")
    return FP32_PEAK_FLOPS, MEM_BYTES_PER_S


def bound(ops: float, ops_peak: float, nbytes: float,
          bw_peak: float) -> dict:
    """The least time for ``ops`` operations and ``nbytes`` bytes: the
    larger of the two over the card's peaks."""
    ops_ms, bytes_ms = ops / ops_peak * 1e3, nbytes / bw_peak * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops_ms=ops_ms, bytes_ms=bytes_ms)


def served_rate(serve, requests: int) -> dict:
    """Served images per second over ``SERVE_WINDOWS`` back-to-back
    windows of whole ``serve()`` runs lasting at least ``SERVE_WINDOW_S``
    each."""
    windows = []
    for _ in range(SERVE_WINDOWS):
        runs = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < SERVE_WINDOW_S:
            serve()
            runs += 1
        dt = time.perf_counter() - t0
        windows.append({"seconds": dt, "requests": runs * requests,
                        "img_per_s": runs * requests / dt})
    rates = [w["img_per_s"] for w in windows]
    return dict(served_img_per_s=statistics.median(rates),
                served_img_per_s_min=min(rates),
                served_img_per_s_max=max(rates), windows=windows)


def profiled(serve, runs: int) -> dict:
    """Where served time goes, under torch.profiler over ``runs`` runs:
    device time by kernel over the wall time (the rest the device waits
    on the host), and the host's time by operation (self time; what no
    operation holds is Python between operations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            serve()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    by_kernel = {e.key: e.self_device_time_total / 1e3 for e in events
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0}
    by_op = {e.key: e.self_cpu_time_total / 1e3 for e in events
             if e.device_type == DeviceType.CPU
             and e.self_cpu_time_total > 0}
    busy_ms = sum(by_kernel.values())
    host_ops_ms = sum(by_op.values())
    return dict(
        profiled_wall_ms=wall_ms,
        device_busy_ms=busy_ms if by_kernel else None,
        device_idle_share=1 - busy_ms / wall_ms if by_kernel else None,
        device_ms_by_kernel=dict(sorted(by_kernel.items(),
                                        key=lambda kv: -kv[1])[:8]),
        host_ops_ms=host_ops_ms, host_between_ops_ms=wall_ms - host_ops_ms,
        host_ms_by_op=dict(sorted(by_op.items(),
                                  key=lambda kv: -kv[1])[:10]))


def median_ms(fn, groups: int = 7, per_group: int = 10,
              warm: int = 3) -> float:
    """Median over ``groups`` of the mean time of ``per_group`` back-to-back
    calls, by CUDA events on the current stream, after ``warm`` calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per_group):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / per_group)
    return statistics.median(times)


def chain_graphs():
    """Two small graphs for the fused-chain cases: an identity block whose
    residual add reads the stem's output from its arena slot, and a block
    whose shortcut reads the chain input, so the input is staged into the
    arena (``input_in_arena``)."""
    from repro_torch.core.decomposition import ConvLayer
    from repro_torch.core.graph import INPUT, GraphNode, NetworkGraph

    def conv(name, ci, co, inputs, relu=True):
        return GraphNode(name, "conv", inputs,
                         layer=ConvLayer(name, 8, 8, ci, co, 3, pad=1),
                         relu=relu)

    ident = NetworkGraph("identity_block", (8, 8, 3), (
        conv("stem", 3, 8, (INPUT,)), conv("c1", 8, 8, ("stem",)),
        conv("c2", 8, 8, ("c1",), relu=False),
        GraphNode("add", "add", ("c2", "stem"), relu=True)), "add")
    staged = NetworkGraph("input_in_arena", (8, 8, 8), (
        conv("c1", 8, 8, (INPUT,)), conv("c2", 8, 8, ("c1",), relu=False),
        GraphNode("add", "add", ("c2", INPUT), relu=True)), "add")
    return ident, staged


def chain_cases(batch: int, quantized: bool):
    """``(name, GraphKernelProgram, batch)`` per fused-chain case: AlexNet's
    two chains at the default budget, the whole network as one chain at
    16 MB, the 281-step chain of the 64 KB plans replayed 1:1
    (``vmem_budget=None``, batch 2), the two small blocks and MobileNet-v1's
    27-node depthwise chain (32x32, width 8)."""
    from repro_torch.core.model_zoo import network_graph
    from repro_torch.core.streaming import (compile_graph,
                                            graph_chain_programs, plan_graph)
    alex = network_graph("alexnet")
    ident, staged = chain_graphs()
    specs = [
        ("alexnet", alex, 128 * 1024, 8 * 2 ** 20, batch),
        ("alexnet 16 MB", alex, 128 * 1024, 16 * 2 ** 20, batch),
        ("alexnet 64 KB plans, vmem_budget=None", alex, 64 * 1024, None, 2),
        ("identity block (residual slot)", ident, 64 * 1024, 8 * 2 ** 20,
         batch),
        ("input in arena", staged, 64 * 1024, 8 * 2 ** 20, batch),
        ("mobilenet_v1 32x32 w8 (depthwise)",
         network_graph("mobilenet_v1", in_hw=32, width=8), 128 * 1024,
         8 * 2 ** 20, batch)]
    cases = []
    for name, g, sram, budget, b in specs:
        progs = compile_graph(g, plan_graph(g, sram))
        _, _, gkps = graph_chain_programs(g, progs, budget,
                                          quantized=quantized, batch=b)
        for head, gkp in gkps.items():
            cases.append((f"{name}: {'+'.join(s.name for s in gkp.nodes)}"
                          if len(gkp.nodes) <= 5
                          else f"{name}: {len(gkp.nodes)} nodes", gkp, b))
    return cases


def chain_weights(gkp, gen, dev):
    """Random He-normal weights and small biases per chain node."""
    import torch
    out = []
    for spec in gkp.nodes:
        l = spec.kp.wave.program.layer
        fan = l.kernel ** 2 * (l.in_c // l.groups)
        w = torch.randn((l.kernel, l.kernel, l.in_c // l.groups, l.out_c),
                        generator=gen) * (2.0 / fan) ** 0.5
        out.append((w.to(dev), (torch.randn((l.out_c,), generator=gen)
                                * 0.1).to(dev)))
    return out


def chain_quant(gkp, gen, dev):
    """Random int8 weights and int32 bias/requantize vectors per chain
    node, scaled so that int8 outputs spread (as for K3's cases), and
    each node's pre_shift."""
    import torch

    from repro_torch.core.quantization import requant_params
    qops, pres = [], []
    for spec in gkp.nodes:
        l = spec.kp.wave.program.layer
        fan = l.kernel ** 2 * (l.in_c // l.groups)
        wq = torch.randint(-127, 128, (l.kernel, l.kernel,
                                       l.in_c // l.groups, l.out_c),
                           generator=gen, dtype=torch.int8)
        bq = torch.randint(-3000, 3000, (l.out_c,), generator=gen,
                           dtype=torch.int32)
        ratio = (torch.rand((l.out_c,), generator=gen, dtype=torch.float64)
                 * 1.5 + 0.5) * 60 / (fan ** 0.5 * 5376)
        m, shift, pre = requant_params(ratio.numpy(),
                                       fan * 127 * 127 + 3000)
        qops.append((wq.to(dev), bq.to(dev), torch.as_tensor(m, device=dev),
                     torch.as_tensor(shift, device=dev)))
        pres.append(pre)
    return qops, pres


def per_layer_walk(gkp, x, params, launch):
    """The chain run node by node through the per-layer kernel:
    ``launch(kp, x_natural, params_i, residual_natural)`` returns a node's
    padded output; returns the last node's padded output."""
    env = {gkp.input_value: x}
    for i, spec in enumerate(gkp.nodes):
        kp = spec.kp
        l = kp.wave.program.layer
        res = env[spec.residual_value] if spec.residual_value else None
        y = launch(kp, env[spec.in_value], params[i], res)
        if i == len(gkp.nodes) - 1:
            return y
        env[spec.out_value] = y[:, :kp.out_h, :kp.out_w, :l.out_c]



def kernel_g(dev, gen, batch: int) -> "tuple[float, dict]":
    """K2 against its plain version on the same CUDA tensors (to
    ``FP32_TOL``) and against K1 walked node by node (``torch.equal``:
    the same bodies, split and reduction order), per chain case. Returns
    the largest error against the plain version and AlexNet's two chains'
    operands for the timing phase."""
    import torch

    from repro_torch.kernels.wave_replay import ops
    from repro_torch.kernels.wave_replay.graph import (
        pack_graph_weights, wave_replay_graph_plain, wave_replay_graph_raw)
    from repro_torch.kernels.wave_replay.kernel import wave_replay_raw
    from repro_torch.kernels.wave_replay.ref import fp32_error

    def k1(kp, x, wb, res):
        xp, wp, bias = ops.pad_operands(kp, x, *wb)
        table = torch.as_tensor(kp.operand_table(), device=dev)
        rp = ops.pad_residual(kp, res) if res is not None else None
        return wave_replay_raw(kp, xp, wp, bias, table, residual=rp)

    max_err, alex = 0.0, {}
    for name, gkp, b in chain_cases(batch, quantized=False):
        l0 = gkp.nodes[0].kp.wave.program.layer
        x = torch.randn((b, l0.in_h, l0.in_w, l0.in_c), generator=gen).to(dev)
        weights = chain_weights(gkp, gen, dev)
        xp = ops.pad_input(gkp.nodes[0].kp, x)
        wf, bf = pack_graph_weights(gkp, weights)
        table = torch.as_tensor(gkp.operand_table(), device=dev)
        got = wave_replay_graph_raw(gkp, xp, wf, bf, table)
        torch.cuda.synchronize()
        want = wave_replay_graph_plain(gkp, xp, wf, bf, table)
        by_k1 = per_layer_walk(gkp, x, weights, k1)
        torch.cuda.synchronize()
        err, tol = fp32_error(got, want)
        finite = bool(torch.isfinite(got).all())
        equal = bool(torch.equal(got, by_k1))
        emit("kernel_g", case=name, batch=b, nodes=len(gkp.nodes),
             total_steps=gkp.total_steps,
             input_in_arena=gkp.input_in_arena,
             arena_slots=len(gkp.arena.slot_shapes), shape=list(got.shape),
             max_abs_err=err, tol=tol, max_abs_out=float(want.abs().max()),
             finite=finite, equal_to_k1_node_by_node=equal)
        check(finite and err <= tol,
              f"{name}: K2 disagrees with its plain version (err {err} > "
              f"tol {tol}) or is not finite")
        check(equal, f"{name}: K2 differs from K1 run node by node")
        max_err = max(max_err, err)
        if name.startswith("alexnet:"):
            alex[gkp.nodes[0].name] = (gkp, (xp, wf, bf, table))
    return max_err, alex


def kernel_gq(dev, gen, batch: int) -> dict:
    """K4 bit for bit (``torch.equal``) against its plain version and
    against K3 walked node by node, per chain case. Returns AlexNet's two
    chains' operands for the timing phase."""
    import torch

    from repro_torch.kernels.wave_replay.ops import pad_input
    from repro_torch.kernels.wave_replay_q import ops as ops_q
    from repro_torch.kernels.wave_replay_q.graph import (
        pack_graph_operands_q, wave_replay_graph_q_plain,
        wave_replay_graph_q_raw)
    from repro_torch.kernels.wave_replay_q.kernel import wave_replay_q_raw

    alex = {}
    for name, gkp, b in chain_cases(batch, quantized=True):
        l0 = gkp.nodes[0].kp.wave.program.layer
        xq = torch.randint(-127, 128, (b, l0.in_h, l0.in_w, l0.in_c),
                           generator=gen, dtype=torch.int8).to(dev)
        qops, pres = chain_quant(gkp, gen, dev)
        fcs = [None] * len(qops)

        def k3(kp, x, q_pre, res):
            args = ops_q.pad_operands_q(kp, x, *q_pre[0])
            table = torch.as_tensor(kp.operand_table(), device=dev)
            rp = ops_q.pad_residual_q(kp, res) if res is not None else None
            return wave_replay_q_raw(kp, *args, table, pre_shift=q_pre[1],
                                     residual=rp)

        xp = pad_input(gkp.nodes[0].kp, xq)
        flat = pack_graph_operands_q(gkp, qops)
        table = torch.as_tensor(gkp.operand_table(), device=dev)
        got = wave_replay_graph_q_raw(gkp, xp, *flat, table,
                                      pre_shifts=pres, fan_chunks=fcs)
        torch.cuda.synchronize()
        want = wave_replay_graph_q_plain(gkp, xp, *flat, table,
                                         pre_shifts=pres)
        by_k3 = per_layer_walk(gkp, xq, list(zip(qops, pres)), k3)
        torch.cuda.synchronize()
        kl = gkp.out_kp
        valid = want[:, :kl.out_h, :kl.out_w, :gkp.out_layer.out_c].float()
        zero = float((valid == 0).float().mean())
        sat = float((valid.abs() == 127).float().mean())
        equal = bool(torch.equal(got, want))
        equal_k3 = bool(torch.equal(got, by_k3))
        emit("kernel_gq", case=name, batch=b, nodes=len(gkp.nodes),
             total_steps=gkp.total_steps, pre_shifts=pres,
             shape=list(got.shape), equal=equal,
             max_abs_diff=int((got.int() - want.int()).abs().max()),
             equal_to_k3_node_by_node=equal_k3, share_zero=zero,
             share_saturated=sat)
        check(got.dtype == torch.int8 and equal,
              f"{name}: K4 differs from its plain version")
        check(equal_k3, f"{name}: K4 differs from K3 run node by node")
        check(zero < 1.0 and sat < 1.0,
              f"{name}: outputs all zero or all saturated, the case tests "
              f"nothing")
        if name.startswith("alexnet:"):
            alex[gkp.nodes[0].name] = (gkp, (xp,) + flat + (table,), pres)
    return alex




def k6_calls(graph, weights, env, mode: str, skip=()):
    """The streaming conv calls (K6's operands) of one forward of the wave
    or scan executor with ``conv_backend="pallas"``, captured by running
    each conv node's executor (on the reference activations ``env``) with
    a conv_fn that records ``(node, x view, w view, stride)`` and answers
    with the direct conv, so the capture launches no kernel. Nodes in
    ``skip`` (those a fused pool serves) are left out."""
    from repro_torch.core.streaming import (_partition_waves_cached,
                                            _scan_executor, _wave_executor,
                                            compile_graph, conv2d_direct,
                                            plan_graph)
    progs = compile_graph(graph, plan_graph(graph))
    calls = []
    for n in graph.conv_nodes():
        if n.name in skip:
            continue
        l, p = n.layer, progs[n.name]
        w, b = weights[n.name]

        def record(xt, wt, name=n.name, s=l.stride):
            calls.append((name, xt, wt, s))
            return conv2d_direct(xt, wt, s, 0)

        if mode == "wave":
            wp = _partition_waves_cached(p)
            _wave_executor(wp, record, True, env[n.inputs[0]], w, b,
                           wp.tile_operands())
        else:
            _scan_executor(p, record, True, env[n.inputs[0]], w, b,
                           p.operands())
    return calls


def conv_work(x, w, stride: int, out_numel: int):
    """(fp32 operations, bytes) of a VALID conv call: each input read
    once, the output written once."""
    K, cin_g, cout = w.shape[0], w.shape[2], w.shape[3]
    ops = 2 * out_numel * K * K * cin_g
    return ops, 4 * (x.numel() + w.numel() + out_numel)


def kernel_cs(dev, gen, calls_by_mode) -> float:
    """K6 against its plain version on the same CUDA tensors, to
    ``FP32_TOL`` of the output's max: the first, a middle and the last
    call of every AlexNet node on the wave and scan paths (views as the
    executors hand them: conv1's stacked windows at stride 4 and K 11,
    conv3's one-channel slices, every scan step's window and weight
    chunk), and shapes of no AlexNet node (Cin 130 over several cin
    blocks, K 5 at stride 2, K 1, a row count the row block does not
    divide, a transposed view the launcher copies). Returns the largest
    error."""
    import torch

    from repro_torch.kernels.conv_stream.kernel import (conv2d_stream_raw,
                                                        enclosing_dims)
    from repro_torch.kernels.conv_stream.ref import conv2d_stream_plain
    from repro_torch.kernels.wave_replay.ref import fp32_error

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    cases = []
    for mode, calls in calls_by_mode.items():
        by_node = {}
        for c in calls:
            by_node.setdefault(c[0], []).append(c)
        for node, cs in by_node.items():
            picks = sorted({0, len(cs) // 2, len(cs) - 1})
            for i in picks:
                _, x, w, s = cs[i]
                cases.append((f"alexnet.{node} {mode} call {i}/{len(cs)}",
                              x, w, s))
    base = rnd(2, 20, 19, 140)
    cases += [
        ("cin 130, k3 s1, 13 rows", rnd(2, 15, 12, 130),
         rnd(3, 3, 130, 70, scale=0.1), 1),
        ("k5 s2, 9 rows", rnd(3, 21, 19, 5), rnd(5, 5, 5, 7, scale=0.3), 2),
        ("k1, cout 65", rnd(2, 9, 9, 3), rnd(1, 1, 3, 65), 1),
        ("k11 s4 view of a wider tensor", base[:, :, 2:17, 3:9],
         rnd(11, 11, 6, 20, scale=0.1), 4),
        ("transposed view (copied)", rnd(2, 12, 12, 4).transpose(1, 2),
         rnd(3, 3, 4, 8), 1)]
    max_err = 0.0
    for name, x, w, s in cases:
        got = conv2d_stream_raw(x, w, stride=s)
        torch.cuda.synchronize()
        want = conv2d_stream_plain(x, w, stride=s)
        torch.cuda.synchronize()
        err, tol = fp32_error(got, want)
        finite = bool(torch.isfinite(got).all())
        emit("kernel_cs", case=name, x=list(x.shape), x_stride=list(
            x.stride()), in_place=enclosing_dims(x) is not None,
            w=list(w.shape), stride=s, shape=list(got.shape),
            max_abs_err=err, tol=tol, max_abs_out=float(want.abs().max()),
            finite=finite)
        check(finite and err <= tol,
              f"{name}: K6 disagrees with its plain version (err {err} > "
              f"tol {tol}) or is not finite")
        max_err = max(max_err, err)
    return max_err


def k5_calls(graph, weights, env):
    """The fused conv + ReLU + pool calls of one AlexNet forward with
    ``pool_backend="fused"``: (node, padded x, w, b, layer) of every
    pooled, ReLU'd conv node, on the reference activations."""
    import torch.nn.functional as F
    calls = []
    for n in graph.conv_nodes():
        l = n.layer
        if l.pool > 1 and n.relu:
            p = l.pad
            x = F.pad(env[n.inputs[0]], (0, 0, p, p, p, p))
            calls.append((n.name, x.contiguous(), *weights[n.name], l))
    return calls


def kernel_fcp(dev, gen, alex_calls) -> float:
    """K5 against its plain version on the same CUDA tensors, to
    ``FP32_TOL``: AlexNet conv1 (stride 4, K 11), conv2 (pad 2, two
    groups) and conv5 (pad 1, two groups) at batch 8 with 3/2 pools, a
    non-overlapping 2/2 pool, a 3/3 pool, and pooled rows that do not fill
    the plain version's last row block. Returns the largest error."""
    import torch

    from repro_torch.kernels.fused_conv_pool.kernel import \
        fused_conv_pool_raw
    from repro_torch.kernels.fused_conv_pool.ref import \
        fused_conv_pool_plain
    from repro_torch.kernels.wave_replay.ref import fp32_error

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    cases = [(f"alexnet.{name}", x, w, b,
              dict(stride=l.stride, pool=l.pool,
                   pool_stride=l.pool_stride or l.pool, groups=l.groups))
             for name, x, w, b, l in alex_calls]
    cases += [
        ("2/2 pool, 18x18x4 -> 8, no bias", rnd(2, 18, 18, 4),
         rnd(3, 3, 4, 8, scale=0.3), None,
         dict(stride=1, pool=2, pool_stride=2, groups=1)),
        ("3/3 pool, two groups", rnd(2, 16, 16, 8),
         rnd(3, 3, 4, 16, scale=0.3), rnd(16, scale=0.1),
         dict(stride=1, pool=3, pool_stride=3, groups=2)),
        ("3/2 pool, 5 pooled rows (last row block not full), stride 2",
         rnd(2, 24, 23, 6), rnd(3, 3, 6, 70, scale=0.3), rnd(70, scale=0.1),
         dict(stride=2, pool=3, pool_stride=2, groups=1))]
    max_err = 0.0
    for name, x, w, b, kw in cases:
        got = fused_conv_pool_raw(x, w, b, **kw)
        torch.cuda.synchronize()
        want = fused_conv_pool_plain(x, w, b, **kw)
        torch.cuda.synchronize()
        err, tol = fp32_error(got, want)
        finite = bool(torch.isfinite(got).all())
        emit("kernel_fcp", case=name, x=list(x.shape), w=list(w.shape),
             bias=b is not None, **kw, shape=list(got.shape),
             max_abs_err=err, tol=tol, max_abs_out=float(want.abs().max()),
             finite=finite)
        check(finite and err <= tol,
              f"{name}: K5 disagrees with its plain version (err {err} > "
              f"tol {tol}) or is not finite")
        max_err = max(max_err, err)
    return max_err


def one_launch_each(counted, own: str, calls) -> "tuple[list, int]":
    """Run each thunk of ``calls`` (a public-op call) with every kernel's
    count set to 0 just before and read just after; fail unless it
    launched kernel ``own`` once and nothing else. Returns the outputs
    and ``own``'s launches."""
    outs, launched = [], 0
    for call in calls:
        for k in counted.values():
            k.reset_launch_count()
        outs.append(call())
        n = {name: k.launch_count() for name, k in counted.items()}
        check(n[own] == 1 and sum(n.values()) == 1,
              f"one {own} public-op call launched {n}")
        launched += n[own]
    return outs, launched


def same(a, b) -> bool:
    """Equal dtype, shape and values, a NaN matching a NaN."""
    import torch
    nan_a, nan_b = a.isnan(), b.isnan()
    return a.dtype == b.dtype and torch.equal(nan_a, nan_b) and torch.equal(
        torch.where(nan_a, 0, a), torch.where(nan_b, 0, b))


def kernel_mp(dev, gen, counted) -> "tuple[int, list]":
    """K7 through its public op, once per call, against its plain version
    on the same CUDA tensors and against ``maxpool_ref`` (equal where the
    reference's -inf start and the kernel's -3e38 agree): AlexNet's three
    pools at batch 8 (the path: its launches are returned), the reference
    test's five cases at ``row_block=4``, a ragged 2/2 pool, a pool with
    stride > pool, bf16, and an input holding NaN and -inf. Returns the
    path's launches and its (name, x, kwargs)."""
    import torch

    from repro_torch.kernels.maxpool_stream.ops import maxpool_stream
    from repro_torch.kernels.maxpool_stream.ref import (
        NEG, maxpool_ref, maxpool_stream_plain)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    path = [(f"alexnet.{n} pool 3/2", rnd(BATCH, h, h, c),
             dict(pool=3, stride=2))
            for n, h, c in (("conv1", 55, 96), ("conv2", 27, 256),
                            ("conv5", 13, 256))]
    odd = rnd(2, 13, 13, 40)
    odd[0, 2, 3, 5] = float("nan")
    odd[1, :3, :3, 7] = float("-inf")          # a whole window
    odd[1, 6, 6, 9] = float("-inf")            # one tap of a window
    cases = [(f"reference test {h}x{w}x{c} {p}/{ps}", rnd(2, h, w, c),
              dict(pool=p, stride=ps, row_block=4))
             for h, w, c, p, ps in ((8, 8, 4, 2, 2), (13, 13, 8, 3, 2),
                                    (27, 27, 16, 3, 3), (14, 10, 4, 2, 2),
                                    (55, 55, 8, 3, 2))]
    cases += [
        ("2/2, ragged W 11, C 40", rnd(2, 9, 11, 40), dict(pool=2)),
        ("2/3 (stride > pool)", rnd(2, 17, 14, 6), dict(pool=2, stride=3)),
        ("bf16 alexnet.conv1 pool 3/2", rnd(BATCH, 55, 55, 96,
                                      dtype=torch.bfloat16),
         dict(pool=3, stride=2)),
        ("NaN and -inf, 3/2", odd, dict(pool=3, stride=2))]
    outs, launched = one_launch_each(
        counted, "K7", [lambda x=x, kw=kw: maxpool_stream(x, **kw)
                        for _, x, kw in path])
    more, _ = one_launch_each(
        counted, "K7", [lambda x=x, kw=kw: maxpool_stream(x, **kw)
                        for _, x, kw in cases])
    torch.cuda.synchronize()
    for (name, x, kw), got in zip(path + cases, outs + more):
        want = maxpool_stream_plain(x, **kw)
        ref = maxpool_ref(x, pool=kw["pool"], stride=kw.get("stride", 0))
        below = ref.float() < NEG
        from_ref = torch.where(below, torch.tensor(NEG).to(ref.dtype), ref)
        equal, equal_ref = same(got, want), same(got, from_ref)
        emit("kernel_mp", case=name, x=list(x.shape), dtype=str(x.dtype),
             **kw, shape=list(got.shape), equal=equal,
             equal_to_maxpool_ref_above_neg=equal_ref,
             nan_out=int(got.isnan().sum()), below_neg_in_ref=int(
                 below.sum()))
        check(equal and equal_ref, f"{name}: K7 differs from its plain "
              f"version or from maxpool_ref")
        if name.startswith("NaN"):
            check(bool(got.isnan().any()) and bool(below.any()),
                  f"{name}: the case shows neither NaN nor -inf")
    return launched, path


def kernel_qmm(dev, gen, counted) -> "tuple[int, list]":
    """K8 through its public op, once per call, ``torch.equal`` to
    ``quant_matmul_ref`` and to its plain version on the same CUDA
    tensors, and at unit scales (its output then the accumulator itself)
    to the float64 oracle ``quant_matmul_acc_ref``: AlexNet's int8 gemms
    at batch 8 (conv3's im2col, conv2's per group, the head's two layers,
    quantized on the card from fp32; the path: its launches are
    returned), the reference test's four blockings, M = 1 with K not a
    multiple of 4, and qmin/qmax operands at K 512. Then the quantizers on
    the card equal them on the CPU at exact halves of the scale. Returns
    the path's launches and its (name, xq, wq, sx, sw)."""
    import torch

    from repro_torch.kernels.quant_matmul.ops import (quant_matmul,
                                                      quantize_activations,
                                                      quantize_weights)
    from repro_torch.kernels.quant_matmul.ref import (quant_matmul_acc_ref,
                                                      quant_matmul_plain,
                                                      quant_matmul_ref)

    def quantized(M, K, N):
        x = torch.randn((M, K), generator=gen).to(dev)
        w = (torch.randn((K, N), generator=gen) * 0.05).to(dev)
        return (*quantize_activations(x), *quantize_weights(w))

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen,
                             dtype=torch.int8).to(dev)

    def scales(n):
        return (torch.rand((n,), generator=gen) * 0.019 + 1e-3).to(dev)

    path = []
    for name, (M, K, N) in (
            ("alexnet.conv3 im2col", (BATCH * 13 * 13, 3 * 3 * 256, 384)),
            ("alexnet.conv2 im2col, one group",
             (BATCH * 27 * 27, 5 * 5 * 48, 128)),
            ("alexnet head fc1", (BATCH, 6 * 6 * 256, 256)),
            ("alexnet head fc2", (BATCH, 256, 1000))):
        xq, sx, wq, sw = quantized(M, K, N)
        path.append((name, xq, wq, sx, sw, {}))
    cases = [(f"reference test {M}x{K}x{N} blocks {bm}/{bn}/{bk}",
              i8(M, K), i8(K, N), 0.02, scales(N),
              dict(block_m=bm, block_n=bn, block_k=bk))
             for M, K, N, bm, bn, bk in ((64, 64, 64, 32, 32, 32),
                                         (100, 70, 50, 32, 16, 32),
                                         (16, 256, 8, 16, 8, 64),
                                         (1, 64, 128, 8, 64, 32))]
    cases.append(("M 1, K 37, N 19", i8(1, 37), i8(37, 19), 0.02,
                  scales(19), {}))
    cases.append(("qmin/qmax, K 512", torch.full((32, 512), -128,
                                                 dtype=torch.int8,
                                                 device=dev),
                  torch.cat([torch.full((512, 8), -128, dtype=torch.int8),
                             torch.full((512, 8), 127, dtype=torch.int8)],
                            1).to(dev), 1.0,
                  torch.ones((16,), device=dev), {}))
    calls = [lambda c=c: quant_matmul(c[1], c[2], c[3], c[4], **c[5])
             for c in path + cases]
    unit = [lambda c=c: quant_matmul(c[1], c[2], 1.0, torch.ones(
        (c[2].shape[1],), device=dev), **c[5]) for c in path + cases]
    outs, launched = one_launch_each(counted, "K8", calls[:len(path)])
    more, _ = one_launch_each(counted, "K8", calls[len(path):] + unit)
    torch.cuda.synchronize()
    outs += more
    for i, (name, xq, wq, sx, sw, kw) in enumerate(path + cases):
        got, acc_f = outs[i], outs[len(path) + len(cases) + i]
        acc = quant_matmul_acc_ref(xq, wq)
        equal_ref = torch.equal(got, quant_matmul_ref(xq, wq, sx, sw))
        equal_plain = torch.equal(got, quant_matmul_plain(xq, wq, sx, sw,
                                                          **kw))
        max_acc = int(acc.abs().max())
        equal_acc = torch.equal(acc_f, acc.float())
        emit("kernel_qmm", case=name, m_k_n=[xq.shape[0], xq.shape[1],
                                              wq.shape[1]], **kw,
             equal_to_quant_matmul_ref=equal_ref,
             equal_to_plain=equal_plain, accumulator_equal=equal_acc,
             max_abs_acc=max_acc, acc_exact_in_fp32=max_acc < 2 ** 24)
        check(got.dtype == torch.float32 and equal_ref and equal_plain
              and equal_acc, f"{name}: K8 differs from quant_matmul_ref, "
              f"its plain version or the float64 accumulator")

    # the quantizers at exact halves of their derived scales
    def ties(amax):
        scale = torch.tensor(amax) / torch.tensor(127.0)
        k = torch.arange(-127, 127, dtype=torch.float32)
        return torch.cat([(k + 0.5) * scale, torch.tensor([amax])])

    x = ties(2.9137).repeat(64)
    w = torch.stack([ties(a) for a in (0.0371, 1.5, 7.25e-3)], 1)
    q_cpu, s_cpu = quantize_activations(x)
    q_card, s_card = quantize_activations(x.to(dev))
    wq_cpu, sw_cpu = quantize_weights(w)
    wq_card, sw_card = quantize_weights(w.to(dev))
    equal = (torch.equal(q_card.cpu(), q_cpu)
             and torch.equal(s_card.cpu(), s_cpu)
             and torch.equal(wq_card.cpu(), wq_cpu)
             and torch.equal(sw_card.cpu(), sw_cpu))
    emit("kernel_qmm", case="quantizers at exact halves, card vs CPU",
         values=x.numel() + w.numel(), equal=equal)
    check(equal, "quantize_activations/quantize_weights on the card differ "
          "from the CPU's")
    return launched, [c[:5] for c in path]


FA_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
# fp32 rounding between two orders of summation at S = T = 4096 reaches
# about 1e-6 (K9 against attention_ref in fp32); the bf16 checks allow
# this much on top of their ULP bounds.
FA_FP32_SLACK = 4e-6


def bf16_ulp(x):
    """One bf16 unit in the last place of each value of the fp32 tensor
    ``x`` (0 where ``x`` is 0): 2**(e - 8) for ``x = m * 2**e``, m in
    [0.5, 1), since bf16 keeps 8 significant bits."""
    import torch

    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def bf16_ulp_errors(got, want, exact) -> "tuple[float, float]":
    """How far a bf16 result ``got`` lies from ``want``, another bf16
    rounding of the same attention, in ULPs of the larger of the two
    (at most 1 where both round the fp32 value once), and from ``exact``,
    the fp32 attention of the same bf16 inputs, in ULPs of ``got``
    (at most 1/2 for a round to nearest). ``FA_FP32_SLACK`` is taken off
    each difference first. A bf16 attention that scores, keeps softmax
    or stores in bf16 past one rounding, or truncates, leaves these
    bounds, where 2e-2 absolute would not see it at S = 4096 (the
    outputs there are about 2e-2)."""
    import torch

    g, w = got.float(), want.float()
    excess = ((g - w).abs() - FA_FP32_SLACK).clamp_min(0)
    vs_want = excess / bf16_ulp(torch.maximum(g.abs(), w.abs()))
    excess = ((g - exact).abs() - FA_FP32_SLACK).clamp_min(0)
    vs_exact = excess / bf16_ulp(g)
    return (float(vs_want.nan_to_num(0.0).max()),
            float(vs_exact.nan_to_num(0.0).max()))


def kernel_fa(dev, gen, counted) -> "tuple[int, float, list]":
    """K9 through its public op, once per call, against its plain version
    and ``attention_ref`` on the same CUDA tensors (TF32 off), to 2e-5 in
    fp32 and 2e-2 in bf16 (the reference test's tolerances): a Qwen3-1.7B
    attention layer at prefill (H 16, KV 8, D 128, S = T = 4096, causal)
    in fp32 and bf16 and a Gemma3-4B local layer at the widths of the
    repo's ``configs/gemma3_4b.py`` (H 8, KV 4, window 1024, D 320 =
    d_model / n_heads there, which sets no head_dim; the published model
    has 256) at 4096 (the path: its launches are returned); the
    reference test's five cases and its dtype case at blocks of 32; S
    not divisible by the block; T != S without causal. A bf16 result is
    held, besides, to one bf16 ULP of its plain version and of
    ``attention_ref``, and to half a ULP of the fp32 attention of the same
    bf16 inputs (``bf16_ulp_errors``). The plain version runs once per
    case, timed by CUDA events. Returns the path's
    launches, the largest error and the path's (name, q, k, v, kwargs,
    plain ms)."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref, flash_attention_plain)

    def qkv(B, H, KV, S, T, D, dtype=torch.float32):
        return tuple(torch.randn(shape, generator=gen).to(dev, dtype)
                     for shape in ((B, H, S, D), (B, KV, T, D),
                                   (B, KV, T, D)))

    bf16 = torch.bfloat16
    n = PREFILL
    path = [("qwen3-1.7b prefill fp32", qkv(1, 16, 8, n, n, 128),
             dict(causal=True)),
            ("qwen3-1.7b prefill bf16", qkv(1, 16, 8, n, n, 128, bf16),
             dict(causal=True)),
            ("gemma3-4b local layer fp32 (repo config D 320; "
             "published 256)", qkv(1, 8, 4, n, n, 320),
             dict(causal=True, window=1024))]
    b32 = dict(block_q=32, block_k=32)
    cases = [(f"reference test {B}x{H}/{KV}x{S}x{D} causal {c} window {w}",
              qkv(B, H, KV, S, T, D), dict(causal=c, window=w, **b32))
             for B, H, KV, S, T, D, c, w in (
                 (2, 4, 2, 64, 64, 16, True, 0),
                 (1, 8, 8, 128, 128, 32, True, 0),
                 (2, 4, 1, 96, 96, 16, True, 32),
                 (1, 2, 2, 64, 64, 16, False, 0),
                 (2, 4, 2, 60, 60, 16, True, 0))]
    cases += [("reference dtype case fp32", qkv(1, 4, 2, 64, 64, 16), b32),
              ("reference dtype case bf16", qkv(1, 4, 2, 64, 64, 16, bf16),
               b32),
              ("S 1000 (blocks of 128 do not divide it), D 64",
               qkv(2, 4, 2, 1000, 1000, 64), dict(causal=True)),
              ("T 160 != S 96, not causal, blocks 40/64",
               qkv(1, 2, 2, 96, 160, 16),
               dict(causal=False, block_q=40, block_k=64))]
    outs, launched = one_launch_each(
        counted, "K9", [lambda c=c: flash_attention(*c[1], **c[2])
                        for c in path])
    more, _ = one_launch_each(
        counted, "K9", [lambda c=c: flash_attention(*c[1], **c[2])
                        for c in cases])
    torch.cuda.synchronize()
    max_err, timed = 0.0, []
    for i, ((name, (q, k, v), kw), got) in enumerate(zip(path + cases,
                                                         outs + more)):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        want = flash_attention_plain(q, k, v, **kw)
        e.record()
        e.synchronize()
        mask_kw = {a: kw[a] for a in ("causal", "window") if a in kw}
        ref = attention_ref(q, k, v, **mask_kw)
        err = float((got.float() - want.float()).abs().max())
        err_ref = float((got.float() - ref.float()).abs().max())
        tol = FA_TOL[str(q.dtype)]
        finite = bool(torch.isfinite(got).all())
        ulps = {}
        if q.dtype == torch.bfloat16:
            exact = attention_ref(q.float(), k.float(), v.float(),
                                  **mask_kw)
            ulps["ulps_vs_plain"], ulps["ulps_vs_exact"] = \
                bf16_ulp_errors(got, want, exact)
            ulps["ulps_vs_attention_ref"], _ = bf16_ulp_errors(got, ref,
                                                               exact)
            del exact
        emit("kernel_fa", case=name, q=list(q.shape), kv=list(k.shape),
             dtype=str(q.dtype), **kw, max_abs_err=err,
             max_abs_err_vs_attention_ref=err_ref, tol=tol, **ulps,
             finite=finite, plain_ms=s.elapsed_time(e))
        check(got.dtype == q.dtype and finite and err < tol
              and err_ref < tol, f"{name}: K9 off its plain version "
              f"({err}) or attention_ref ({err_ref}), tol {tol}")
        check(not ulps or (ulps["ulps_vs_plain"] <= 1
                           and ulps["ulps_vs_attention_ref"] <= 1
                           and ulps["ulps_vs_exact"] <= 0.5),
              f"{name}: bf16 K9 off by more than one rounding {ulps}")
        max_err = max(max_err, err)
        if i < len(path):
            timed.append((name, (q, k, v), kw, s.elapsed_time(e)))
    return launched, max_err, timed


def attention_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a masked attention computes: S * T, the
    causal triangle, or the band of the window."""
    if not causal:
        return S * T
    return sum(max(0, min(q + 1, T) - (max(0, q - window + 1) if window
                                        else 0)) for q in range(S))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script needs the card",
              file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    import torch.nn.functional as F

    from repro_torch.core import decomposition as dec
    from repro_torch.core.model_zoo import network_graph
    from repro_torch.core.quantization import (dequantize_int8,
                                               quantize_int8_sym,
                                               requant_params)
    from repro_torch.core.schedule import (compile_layer,
                                           lower_kernel_program,
                                           partition_waves)
    from repro_torch.core.streaming import (_graph_epilogues,
                                            _graph_kernel_program,
                                            compile_graph, conv2d_direct,
                                            graph_kernel_programs,
                                            plan_graph, run_graph_reference)
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv_stream import kernel as k6
    from repro_torch.kernels.conv_stream.kernel import conv2d_stream_raw
    from repro_torch.kernels.conv_stream.ref import conv2d_stream_plain
    from repro_torch.kernels.flash_attention import kernel as k9
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_conv_pool import kernel as k5
    from repro_torch.kernels.fused_conv_pool.kernel import \
        fused_conv_pool_raw
    from repro_torch.kernels.fused_conv_pool.ref import \
        fused_conv_pool_plain
    from repro_torch.kernels.maxpool_stream import kernel as k7
    from repro_torch.kernels.maxpool_stream.ops import maxpool_stream
    from repro_torch.kernels.maxpool_stream.ref import maxpool_stream_plain
    from repro_torch.kernels.quant_matmul import kernel as k8
    from repro_torch.kernels.quant_matmul.ops import quant_matmul
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_plain
    from repro_torch.kernels.wave_replay import graph as k2
    from repro_torch.kernels.wave_replay import ops
    from repro_torch.kernels.wave_replay.graph import (
        wave_replay_graph_plain, wave_replay_graph_raw)
    from repro_torch.kernels.wave_replay.kernel import (launch_geometry,
                                                        wave_replay_raw)
    from repro_torch.kernels.wave_replay.ref import (fp32_error,
                                                     wave_replay_plain)
    from repro_torch.kernels.wave_replay_q import graph as k4
    from repro_torch.kernels.wave_replay_q import ops as ops_q
    from repro_torch.kernels.wave_replay_q.graph import (
        wave_replay_graph_q_plain, wave_replay_graph_q_raw)
    from repro_torch.kernels.wave_replay_q.kernel import wave_replay_q_raw
    from repro_torch.kernels.wave_replay_q.ref import wave_replay_q_plain
    from repro_torch.launch.session import StreamingSession
    from repro_torch.models.cnn import init_graph_weights
    from repro_torch.quant.accuracy import quant_graph_reference_acts, snr_db
    from repro_torch.quant.calibrate import calibrate_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    flops_peak, bw_peak = peaks_for(kind)
    emit("card", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, fp32_peak_flops=flops_peak,
         bf16_peak_flops=BF16_PEAK_FLOPS, int8_peak_ops=INT8_PEAK_OPS,
         mem_bytes_per_s=bw_peak)

    # 2. build: one nvcc per source, all started together
    stems = ("wave_replay", "wave_replay_q", "wave_replay_graph",
             "wave_replay_graph_q", "conv_stream", "fused_conv_pool",
             "maxpool_stream", "quant_matmul", "flash_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(stems)) as pool:
        reports = dict(zip(stems, pool.map(_build.build, stems)))
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds={k: r["seconds"] for k, r in reports.items()},
         ptxas={k: [ln for ln in r["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, r in reports.items()})

    # 3. the fp32 kernel against its plain version, one phase per branch
    gen = torch.Generator().manual_seed(0)

    def operands(kp, batch):
        l = kp.wave.program.layer
        x = torch.randn((batch, l.in_h, l.in_w, l.in_c), generator=gen)
        w = torch.randn((l.kernel, l.kernel, l.in_c // l.groups, l.out_c),
                        generator=gen) * (2.0 / (l.kernel ** 2 * l.in_c
                                                 // l.groups)) ** 0.5
        b = torch.randn((l.out_c,), generator=gen) * 0.1
        r = torch.randn((batch, kp.out_h, kp.out_w, l.out_c),
                        generator=gen) if kp.residual else None
        x, w, b = x.to(dev), w.to(dev), b.to(dev)
        xp, wp, bias = ops.pad_operands(kp, x, w, b)
        rp = ops.pad_residual(kp, r.to(dev)) if r is not None else None
        table = torch.as_tensor(kp.operand_table(), device=dev)
        return (x, w, b), (xp, wp, bias, table, rp)

    def node_program(graph, name, batch):
        n = graph.node(name)
        relu, resv, _ = _graph_epilogues(graph)[name]
        prog = compile_layer(n.layer, dec.plan_decomposition(n.layer,
                                                             128 * 1024))
        return _graph_kernel_program(prog, relu, resv is not None,
                                     8 * 2 ** 20, batch)

    alex = network_graph("alexnet")
    alex_kps = graph_kernel_programs(
        alex, compile_graph(alex, plan_graph(alex)), batch=BATCH)
    cases = [(f"alexnet.{n}", kp) for n, kp in alex_kps.items()]
    cases.append(("resnet18.s1b1_c2 (residual)", node_program(
        network_graph("resnet18", in_hw=64, width=64), "s1b1_c2", BATCH)))
    cases.append(("mobilenet_v1.dw2 (depthwise)", node_program(
        network_graph("mobilenet_v1", in_hw=64, width=32), "dw2", BATCH)))
    mult = dec.ConvLayer("dw_x2", 28, 28, 32, 64, 3, pad=1, groups=32)
    cases.append(("depthwise x2 multiplier", lower_kernel_program(
        partition_waves(compile_layer(mult, dec.evaluate(mult, 1, 1, 1, 1))),
        relu=True, batch_block=BATCH)))
    conv3 = alex.node("conv3").layer
    cases.append(("alexnet.conv3 vmem_budget=None 2x2 tiles x4 chain",
                  lower_kernel_program(partition_waves(compile_layer(
                      conv3, dec.evaluate(conv3, 2, 2, 1, 4))),
                      relu=True, vmem_budget=None, batch_block=BATCH)))

    def is_alex_layer(name):
        return name.startswith("alexnet.conv") and " " not in name

    max_err = 0.0
    layer_ops = {}
    for name, kp in cases:
        natural, (xp, wp, bias, table, rp) = operands(kp, BATCH)
        got = wave_replay_raw(kp, xp, wp, bias, table, residual=rp)
        torch.cuda.synchronize()
        want = wave_replay_plain(kp, xp, wp, bias, table, residual=rp)
        torch.cuda.synchronize()
        err, tol = fp32_error(got, want)
        finite = bool(torch.isfinite(got).all())
        g = launch_geometry(kp, BATCH)
        emit("kernel", case=name, shape=list(got.shape),
             n_tiles=kp.n_tiles, n_chain=kp.n_chain, groups=kp.groups,
             pool=[kp.pool, kp.pool_stride], residual=kp.residual,
             body="depthwise" if g.depthwise else "gemm",
             cta_block=[g.cta_ph, g.cta_pw], max_abs_err=err, tol=tol,
             max_abs_out=float(want.abs().max()), finite=finite)
        check(finite and err <= tol,
              f"{name}: kernel disagrees with its plain version "
              f"(err {err} > tol {tol}) or is not finite")
        max_err = max(max_err, err)
        if is_alex_layer(name):
            layer_ops[name.split(".")[1]] = (kp, natural,
                                             (xp, wp, bias, table, rp))

    # 4. the int8 kernel against its plain version, bit for bit
    def operands_q(kp, batch):
        l = kp.wave.program.layer
        fan = l.kernel ** 2 * (l.in_c // l.groups)

        def i8(shape):
            return torch.randint(-127, 128, shape, generator=gen,
                                 dtype=torch.int8)

        xq = i8((batch, l.in_h, l.in_w, l.in_c))
        wq = i8((l.kernel, l.kernel, l.in_c // l.groups, l.out_c))
        bq = torch.randint(-3000, 3000, (l.out_c,), generator=gen,
                           dtype=torch.int32)
        # output scale so the int8 outputs spread: |acc| ~ sqrt(fan) *
        # 127^2 / 3 for uniform operands
        ratio = (torch.rand((l.out_c,), generator=gen, dtype=torch.float64)
                 * 1.5 + 0.5) * 60 / (fan ** 0.5 * 5376)
        m, shift, pre = requant_params(ratio.numpy(),
                                       fan * 127 * 127 + 3000)
        r = i8((batch, kp.out_h, kp.out_w, l.out_c)) if kp.residual \
            else None
        xq, wq, bq = xq.to(dev), wq.to(dev), bq.to(dev)
        m, shift = torch.as_tensor(m, device=dev), torch.as_tensor(
            shift, device=dev)
        padded = ops_q.pad_operands_q(kp, xq, wq, bq, m, shift)
        rp = ops_q.pad_residual_q(kp, r.to(dev)) if r is not None else None
        table = torch.as_tensor(kp.operand_table(), device=dev)
        return (xq, wq), padded + (table,), pre, rp

    layer_ops_q = {}
    for name, kp in cases:
        natural, args, pre, rp = operands_q(kp, BATCH)
        got = wave_replay_q_raw(kp, *args, pre_shift=pre, residual=rp)
        torch.cuda.synchronize()
        want = wave_replay_q_plain(kp, *args, pre_shift=pre, residual=rp)
        torch.cuda.synchronize()
        l = kp.wave.program.layer
        valid = want[:, :kp.out_h, :kp.out_w, :l.out_c].float()
        zero = float((valid == 0).float().mean())
        sat = float((valid.abs() == 127).float().mean())
        diff = int((got.int() - want.int()).abs().max())
        emit("kernel_q", case=name, shape=list(got.shape), pre_shift=pre,
             n_tiles=kp.n_tiles, n_chain=kp.n_chain, groups=kp.groups,
             residual=kp.residual, equal=bool(torch.equal(got, want)),
             max_abs_diff=diff, share_zero=zero, share_saturated=sat)
        check(got.dtype == torch.int8 and torch.equal(got, want),
              f"{name}: K3 differs from its plain version (max |diff| "
              f"{diff})")
        check(zero < 1.0 and sat < 1.0,
              f"{name}: outputs all zero or all saturated, the case "
              f"tests nothing")
        if is_alex_layer(name):
            layer_ops_q[name.split(".")[1]] = (kp, natural, args, pre)

    # 5-6. the fused-chain kernels against their plain versions and
    # against the per-layer kernels walked node by node
    err_g, chain_ops = kernel_g(dev, gen, BATCH)
    chain_ops_q = kernel_gq(dev, gen, BATCH)

    # 7. entry quantization: the card rounds as the CPU does at ties
    scale = 0.0371
    k = torch.arange(-140, 140, dtype=torch.float32).repeat(3572)
    ties = (k + 0.5) * torch.tensor(scale, dtype=torch.float32)
    on_card = quantize_int8_sym(ties.to(dev), scale).cpu()
    on_cpu = quantize_int8_sym(ties, scale)
    by_recip = torch.clamp(torch.round(ties.to(dev) * (1.0 / scale)),
                           -127, 127).to(torch.int8).cpu()
    emit("quant", values=ties.numel(),
         equal=bool(torch.equal(on_card, on_cpu)),
         reciprocal_multiply_mismatches=int((by_recip != on_cpu).sum()))
    check(torch.equal(on_card, on_cpu),
          "entry quantization on the card differs from the CPU's")

    # 8. the fp32 main path: serve AlexNet requests through the session
    weights = init_graph_weights(alex, torch.Generator().manual_seed(1),
                                 dev)
    sess = StreamingSession.for_graph(alex, weights, max_batch=BATCH,
                                      device=dev)
    imgs = torch.randn((REQUESTS,) + alex.in_shape,
                       generator=torch.Generator().manual_seed(2)).to(dev)
    sess.result(sess.submit(imgs[0]))         # builds the batch-8 forward
    torch.cuda.synchronize()

    def serving(s):
        def serve():
            tickets = [s.submit(imgs[i]) for i in range(REQUESTS)]
            s.flush()
            outs = [s.result(t) for t in tickets]
            torch.cuda.synchronize()
            return outs
        return serve

    counted = {"K1": ops, "K3": ops_q, "K2": k2, "K4": k4, "K5": k5,
               "K6": k6, "K7": k7, "K8": k8, "K9": k9}
    served_k789 = {"K7": 0, "K8": 0, "K9": 0, "forwards": 0}

    def drive(s):
        """One 32-request run with every kernel's count set to 0 just
        before and read just after: (outputs, seconds, batched calls,
        K1, K3 launches, every kernel's count). No serving path runs K7,
        K8 or K9."""
        for k in counted.values():
            k.reset_launch_count()
        calls0 = s.calls
        t0 = time.perf_counter()
        outs = serving(s)()
        n = {name: k.launch_count() for name, k in counted.items()}
        for name in ("K7", "K8", "K9"):
            served_k789[name] += n[name]
        served_k789["forwards"] += s.calls - calls0
        check(n["K7"] == n["K8"] == n["K9"] == 0,
              f"a serving path launched {n}")
        return (outs, time.perf_counter() - t0, s.calls - calls0,
                n["K1"], n["K3"], n)

    outs, first_s, calls, launches, stray_q, n = drive(sess)
    check(calls == REQUESTS // BATCH, f"{calls} batched calls")
    check(launches == 5 * calls and stray_q == 0
          and n["K2"] == n["K4"] == 0,
          f"{n} launches for {calls} fp32 AlexNet calls")
    y_mega = y = torch.stack(outs)
    ref = torch.cat([run_graph_reference(alex, weights,
                                         imgs[i:i + BATCH])[alex.output]
                     for i in range(0, REQUESTS, BATCH)])
    err, tol = fp32_error(y, ref)
    check(tuple(y.shape) == (REQUESTS, 6, 6, 256), f"output {y.shape}")
    check(bool(torch.isfinite(y).all()), "non-finite served output")
    check(err <= tol, f"served output off the reference: {err} > {tol}")
    max_err = max(max_err, err)
    emit("serve", requests=REQUESTS, batch=BATCH, batched_calls=calls,
         kernel_launches=launches, compiles=sess.compile_count,
         seconds=first_s, max_abs_err=err, tol=tol,
         max_abs_out=float(ref.abs().max()))

    # 9. the int8 main path: calibrate on the card, serve the same requests
    t0 = time.perf_counter()
    calib = torch.randn((2,) + alex.in_shape,
                        generator=torch.Generator().manual_seed(7)).to(dev)
    qg = calibrate_graph(alex, weights, calib)
    calib_s = time.perf_counter() - t0
    sess_q = StreamingSession.for_graph(alex, None, max_batch=BATCH,
                                        device=dev, precision="int8",
                                        qnet=qg)
    sess_q.result(sess_q.submit(imgs[0]))
    torch.cuda.synchronize()
    outs, first_q_s, calls_q, stray, launches_q, n = drive(sess_q)
    check(calls_q == REQUESTS // BATCH, f"{calls_q} batched int8 calls")
    check(launches_q == 5 * calls_q and stray == 0
          and n["K2"] == n["K4"] == 0,
          f"{n} launches for {calls_q} int8 AlexNet calls")
    yq = torch.stack(outs)
    raw_sess = StreamingSession.for_graph(alex, None, max_batch=BATCH,
                                          device=dev, precision="int8",
                                          qnet=qg, dequantize=False)
    raw = torch.cat([raw_sess.run_batch(imgs[i:i + BATCH])
                     for i in range(0, REQUESTS, BATCH)])
    want_q = torch.cat([quant_graph_reference_acts(
        qg, imgs[i:i + BATCH])[alex.output]
        for i in range(0, REQUESTS, BATCH)])
    torch.cuda.synchronize()
    out_scale = qg.scales[alex.output]
    check(raw.dtype == torch.int8 and torch.equal(raw, want_q),
          "raw int8 output differs from the int32 reference walk")
    check(torch.equal(yq, dequantize_int8(raw, out_scale)),
          "served int8 output is not the dequantized raw output")
    snr = snr_db(ref, yq)
    emit("serve_q", requests=REQUESTS, batch=BATCH, batched_calls=calls_q,
         k3_launches=launches_q, k1_launches=stray,
         compiles=sess_q.compile_count, seconds=first_q_s,
         calibrate_seconds=calib_s, raw_equal_to_int32_reference=True,
         share_zero=float((raw == 0).float().mean()),
         share_saturated=float((raw.abs() == 127).float().mean()),
         snr_db_vs_fp32=snr, snr_floor_of_the_reference_tests=20.0,
         pre_shift={n: q.pre_shift for n, q in qg.quants.items()})

    # 10. the fp32 whole-graph path: the same requests, one K2 launch per
    # fused chain
    sess_g = StreamingSession.for_graph(alex, weights, max_batch=BATCH,
                                        device=dev, mode="graphkernel")
    sess_g.result(sess_g.submit(imgs[0]))
    torch.cuda.synchronize()
    chains_g = sess_g.health()["launches_per_forward"]
    outs, first_g_s, calls_g, stray_g, stray_gq, n_g = drive(sess_g)
    check(calls_g == REQUESTS // BATCH, f"{calls_g} batched calls")
    check(chains_g == 2 and n_g["K2"] == chains_g * calls_g
          and n_g["K1"] == n_g["K3"] == n_g["K4"] == 0,
          f"{n_g} launches for {calls_g} fp32 graphkernel AlexNet calls")
    y_g = torch.stack(outs)
    err_sg, tol = fp32_error(y_g, ref)
    check(torch.equal(y_g, y_mega),
          "graphkernel output differs from the megakernel session's")
    check(err_sg <= tol, f"graphkernel output off the reference: "
          f"{err_sg} > {tol}")
    emit("serve_g", requests=REQUESTS, batch=BATCH, batched_calls=calls_g,
         k2_launches=n_g["K2"], k1_launches=n_g["K1"],
         launches_per_forward=chains_g, compiles=sess_g.compile_count,
         seconds=first_g_s, equal_to_megakernel=True, max_abs_err=err_sg,
         tol=tol, chains=sess_g.describe().splitlines()[1:])

    # 11. the int8 whole-graph path: one K4 launch per fused chain
    sess_gq = StreamingSession.for_graph(alex, None, max_batch=BATCH,
                                         device=dev, mode="graphkernel",
                                         precision="int8", qnet=qg)
    sess_gq.result(sess_gq.submit(imgs[0]))
    torch.cuda.synchronize()
    outs, first_gq_s, calls_gq, _, _, n_gq = drive(sess_gq)
    check(calls_gq == REQUESTS // BATCH, f"{calls_gq} batched int8 calls")
    check(n_gq["K4"] == 2 * calls_gq
          and n_gq["K1"] == n_gq["K2"] == n_gq["K3"] == 0,
          f"{n_gq} launches for {calls_gq} int8 graphkernel AlexNet calls")
    yq_g = torch.stack(outs)
    raw_g_sess = StreamingSession.for_graph(
        alex, None, max_batch=BATCH, device=dev, mode="graphkernel",
        precision="int8", qnet=qg, dequantize=False)
    raw_g = torch.cat([raw_g_sess.run_batch(imgs[i:i + BATCH])
                       for i in range(0, REQUESTS, BATCH)])
    torch.cuda.synchronize()
    check(raw_g.dtype == torch.int8 and torch.equal(raw_g, want_q),
          "graphkernel raw int8 output differs from the int32 reference "
          "walk")
    check(torch.equal(raw_g, raw) and torch.equal(yq_g, yq),
          "graphkernel int8 output differs from the megakernel session's")
    emit("serve_gq", requests=REQUESTS, batch=BATCH, batched_calls=calls_gq,
         k4_launches=n_gq["K4"], k3_launches=n_gq["K3"],
         launches_per_forward=sess_gq.health()["launches_per_forward"],
         compiles=sess_gq.compile_count, seconds=first_gq_s,
         raw_equal_to_int32_reference=True, equal_to_megakernel=True,
         snr_db_vs_fp32=snr_db(ref, yq_g))

    # 12-13. the streaming conv (K6) and the fused conv + ReLU + pool (K5)
    # against their plain versions, on the operands the wave and scan
    # paths hand them
    env8 = run_graph_reference(alex, weights, imgs[:BATCH])
    fused_nodes = {n.name for n in alex.conv_nodes()
                   if n.layer.pool > 1 and n.relu}
    cs_calls = {"wave": k6_calls(alex, weights, env8, "wave"),
                "scan": k6_calls(alex, weights, env8, "scan")}
    check(len(cs_calls["wave"]) == 257 and len(cs_calls["scan"]) == 1142,
          f"{len(cs_calls['wave'])} / {len(cs_calls['scan'])} K6 calls in "
          f"a wave / scan forward")
    err_cs = kernel_cs(dev, gen, cs_calls)
    fcp_calls = k5_calls(alex, weights, env8)
    err_fcp = kernel_fcp(dev, gen, fcp_calls)

    # 14-16. the streaming max-pool (K7), the int8 matmul (K8) and flash
    # attention (K9) through their public ops, one launch per call
    launches_mp, mp_path = kernel_mp(dev, gen, counted)
    launches_qmm, qmm_path = kernel_qmm(dev, gen, counted)
    launches_fa, err_fa, fa_path = kernel_fa(dev, gen, counted)

    # 17-18. the layer executors: serve the same requests in wave and scan
    # mode with each backend pair; (K6, K5) launches per batched call
    per_call = {("wave", "xla", "xla"): (0, 0),
                ("wave", "pallas", "xla"): (257, 0),
                ("wave", "pallas", "fused"): (256, 3),
                ("scan", "xla", "xla"): (0, 0),
                ("scan", "pallas", "xla"): (1142, 0),
                ("scan", "pallas", "fused"): (1072, 3)}
    served = {}
    err_served = {"K5": 0.0, "K6": 0.0}
    for phase, mode in (("serve_w", "wave"), ("serve_s", "scan")):
        for cb, pb in (("xla", "xla"), ("pallas", "xla"),
                       ("pallas", "fused")):
            s = StreamingSession.for_graph(alex, weights, max_batch=BATCH,
                                           device=dev, mode=mode,
                                           conv_backend=cb, pool_backend=pb)
            s.result(s.submit(imgs[0]))
            torch.cuda.synchronize()
            want6, want5 = per_call[(mode, cb, pb)]
            by_kernel = s.health()["launches_per_forward_by_kernel"]
            outs, secs, calls_ws, _, _, n_ws = drive(s)
            check(calls_ws == REQUESTS // BATCH, f"{calls_ws} batched calls")
            check(by_kernel == {"K5": want5, "K6": want6}
                  and n_ws["K6"] == want6 * calls_ws
                  and n_ws["K5"] == want5 * calls_ws
                  and n_ws["K1"] == n_ws["K2"] == n_ws["K3"]
                  == n_ws["K4"] == 0,
                  f"{mode} {cb}/{pb}: {n_ws} launches for {calls_ws} calls "
                  f"(per call {by_kernel})")
            y_ws = torch.stack(outs)
            err_ws, tol = fp32_error(y_ws, ref)
            check(bool(torch.isfinite(y_ws).all()) and err_ws <= tol,
                  f"{mode} {cb}/{pb} output off the reference: {err_ws} > "
                  f"{tol}")
            extra = {}
            if (mode, cb, pb) == ("wave", "xla", "xla"):
                # the script turns cuDNN's TF32 off, so allow it here as
                # PyTorch does by default: the served output must not move,
                # while a bare F.conv2d of conv3 (the control) must
                x3 = env8["conv2"].permute(0, 3, 1, 2)
                w3 = weights["conv3"][0].permute(3, 2, 0, 1)
                bare = F.conv2d(x3, w3, padding=1)
                torch.backends.cudnn.allow_tf32 = True
                try:
                    y_tf = s.run_batch(imgs[:BATCH])
                    bare_tf = F.conv2d(x3, w3, padding=1)
                    torch.cuda.synchronize()
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                err_tf, tol_tf = fp32_error(y_tf, ref[:BATCH])
                check(err_tf <= tol_tf, f"with TF32 allowed by default the "
                      f"direct conv path is off: {err_tf} > {tol_tf}")
                check(torch.equal(y_tf, y_ws[:BATCH]), "allowing TF32 "
                      "changed the direct conv path's output")
                bare_err, bare_tol = fp32_error(bare_tf, bare)
                check(bare_err > bare_tol, f"control: allowing TF32 left a "
                      f"bare conv3 within fp32 tolerance ({bare_err} <= "
                      f"{bare_tol}), so the check above shows nothing")
                extra = dict(max_abs_err_tf32_allowed_by_default=err_tf,
                             equal_tf32_allowed_by_default=True,
                             bare_conv3_err_tf32_allowed=bare_err,
                             bare_conv3_tol=bare_tol)
            emit(phase, conv_backend=cb, pool_backend=pb, requests=REQUESTS,
                 batch=BATCH, batched_calls=calls_ws,
                 k6_launches=n_ws["K6"], k5_launches=n_ws["K5"],
                 launches_per_call=by_kernel, compiles=s.compile_count,
                 seconds=secs, max_abs_err=err_ws, tol=tol,
                 max_abs_err_vs_megakernel=fp32_error(y_ws, y_mega)[0],
                 **extra)
            served[(mode, cb, pb)] = (s, n_ws)
            if cb == "pallas":
                err_served["K6"] = max(err_served["K6"], err_ws)
            if pb == "fused":
                err_served["K5"] = max(err_served["K5"], err_ws)

    # 19. timing, per AlexNet layer and chain at batch 8, and the served
    # rates
    rows = []
    for name, (kp, (x, w, b), (xp, wp, bias, table, rp)) in \
            layer_ops.items():
        l = kp.wave.program.layer
        ms = median_ms(lambda: wave_replay_raw(kp, xp, wp, bias, table))
        plain_ms = median_ms(
            lambda: wave_replay_plain(kp, xp, wp, bias, table),
            groups=5, per_group=2, warm=1)
        x_nchw = x.permute(0, 3, 1, 2)            # channels-last view
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def library():
            yl = F.relu(F.conv2d(x_nchw, w_oihw, b, stride=l.stride,
                                 padding=l.pad, groups=l.groups))
            return F.max_pool2d(yl, l.pool, l.pool_stride or l.pool) \
                if l.pool > 1 else yl

        library_ms = median_ms(library)
        flops = 2 * l.macs * BATCH
        nbytes = 4 * (x.numel() + w.numel() + b.numel()
                      + BATCH * kp.out_h * kp.out_w * l.out_c)
        rows.append(dict(kernel="K1", layer=name, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms,
                         **bound(flops, flops_peak, nbytes, bw_peak),
                         gflop=flops / 1e9, mbytes=nbytes / 1e6,
                         achieved_tflops=flops / ms / 1e9,
                         launches_per_forward=1))
        emit("timing", **rows[-1], nvidia_smi=smi)
    rows_q = []
    for name, (kp, (xq, wq), args, pre) in layer_ops_q.items():
        l = kp.wave.program.layer
        ms = median_ms(lambda: wave_replay_q_raw(kp, *args, pre_shift=pre))
        plain_ms = median_ms(
            lambda: wave_replay_q_plain(kp, *args, pre_shift=pre),
            groups=5, per_group=2, warm=1)
        # yardstick: the layer's conv as torch._int_mm per group on its
        # im2col (built here, outside the timing), fan padded to a
        # multiple of 8; the gemm only, no requantize epilogue
        K, st, cg = l.kernel, l.stride, l.in_c // l.groups
        opg = l.out_c // l.groups
        xpad = F.pad(xq, (0, 0, l.pad, l.pad, l.pad, l.pad))
        oh, ow = l.out_h, l.out_w
        kpad = -(-K * K * cg // 8) * 8
        gemms = []
        for gi in range(l.groups):
            a = torch.cat([xpad[:, ky:ky + (oh - 1) * st + 1:st,
                                kx:kx + (ow - 1) * st + 1:st,
                                gi * cg:(gi + 1) * cg]
                           for ky in range(K) for kx in range(K)],
                          -1).reshape(-1, K * K * cg)
            a = F.pad(a, (0, kpad - K * K * cg)).contiguous()
            bm = F.pad(wq[..., gi * opg:(gi + 1) * opg].reshape(-1, opg),
                       (0, 0, 0, kpad - K * K * cg))
            gemms.append((a, bm.t().contiguous().t()))   # column-major B

        def library_q():
            return [torch._int_mm(a, bm) for a, bm in gemms]

        library_ms = median_ms(library_q)
        int_ops = 2 * l.macs * BATCH
        nbytes = (xq.numel() + wq.numel() + 3 * 4 * l.out_c
                  + BATCH * kp.out_h * kp.out_w * l.out_c)
        rows_q.append(dict(kernel="K3", layer=name, ms=ms,
                           plain_ms=plain_ms, library_ms=library_ms,
                           **bound(int_ops, INT8_PEAK_OPS, nbytes, bw_peak),
                           gop=int_ops / 1e9, mbytes=nbytes / 1e6,
                           achieved_tops=int_ops / ms / 1e9,
                           launches_per_forward=1))
        emit("timing", **rows_q[-1], nvidia_smi=smi)
    def coop_grid(gkp, stem, suffix):
        """The cooperative grid of a chain's launch: CTAs co-resident on
        the card, and the most any node's phase can use."""
        fit = k2.co_resident_ctas(_build.library(stem),
                                  f"{stem}_{suffix}_occupancy", dev)
        need = k2.launch_plan(gkp, BATCH, lambda *a: []).max_ctas
        return dict(grid_ctas=min(fit, need), co_resident_ctas=fit,
                    largest_phase_ctas=need)

    by_layer = {r["layer"]: r for r in rows}
    rows_g = []
    for head, (gkp, args) in chain_ops.items():
        ms = median_ms(lambda: wave_replay_graph_raw(gkp, *args))
        plain_ms = median_ms(lambda: wave_replay_graph_plain(gkp, *args),
                             groups=5, per_group=2, warm=1)
        layer_rows = [by_layer[sp.name] for sp in gkp.nodes]
        total = {k: sum(r[k] for r in layer_rows)
                 for k in ("bound_ms", "ops_ms", "bytes_ms", "library_ms",
                           "gflop", "ms")}
        rows_g.append(dict(
            kernel="K2", chain="+".join(sp.name for sp in gkp.nodes),
            ms=ms, plain_ms=plain_ms, library_ms=total["library_ms"],
            bound_ms=total["bound_ms"],
            bound_by="operations" if total["ops_ms"] >= total["bytes_ms"]
            else "bytes", ops_ms=total["ops_ms"], bytes_ms=total["bytes_ms"],
            k1_ms_summed=total["ms"], gflop=total["gflop"],
            achieved_tflops=total["gflop"] / ms, launches_per_forward=1,
            **coop_grid(gkp, "wave_replay_graph", "f32")))
        emit("timing", **rows_g[-1], nvidia_smi=smi)
    by_layer_q = {r["layer"]: r for r in rows_q}
    rows_gq = []
    for head, (gkp, args, pres) in chain_ops_q.items():
        fcs = [None] * len(pres)
        ms = median_ms(lambda: wave_replay_graph_q_raw(
            gkp, *args, pre_shifts=pres, fan_chunks=fcs))
        plain_ms = median_ms(lambda: wave_replay_graph_q_plain(
            gkp, *args, pre_shifts=pres), groups=5, per_group=2, warm=1)
        layer_rows = [by_layer_q[sp.name] for sp in gkp.nodes]
        total = {k: sum(r[k] for r in layer_rows)
                 for k in ("bound_ms", "ops_ms", "bytes_ms", "library_ms",
                           "gop", "ms")}
        rows_gq.append(dict(
            kernel="K4", chain="+".join(sp.name for sp in gkp.nodes),
            ms=ms, plain_ms=plain_ms, library_ms=total["library_ms"],
            bound_ms=total["bound_ms"],
            bound_by="operations" if total["ops_ms"] >= total["bytes_ms"]
            else "bytes", ops_ms=total["ops_ms"], bytes_ms=total["bytes_ms"],
            k3_ms_summed=total["ms"], gop=total["gop"],
            achieved_tops=total["gop"] / ms, launches_per_forward=1,
            **coop_grid(gkp, "wave_replay_graph_q", "i8")))
        emit("timing", **rows_gq[-1], nvidia_smi=smi)
    profiled_runs = 4
    for precision, mode, s in (("fp32", "megakernel", sess),
                               ("int8", "megakernel", sess_q),
                               ("fp32", "graphkernel", sess_g),
                               ("int8", "graphkernel", sess_gq)):
        emit("timing", precision=precision, mode=mode,
             **served_rate(serving(s), REQUESTS), batch=BATCH,
             requests_per_run=REQUESTS,
             profiled_requests=profiled_runs * REQUESTS,
             **profiled(serving(s), profiled_runs), nvidia_smi=smi)

    def replay(calls, fn):
        def run():
            for c in calls:
                fn(*c)
        return run

    def device_ms(fn, kernel_name, launches, runs=3, windows=4):
        """``device_ms``: the device time of ``kernel_name`` per ``fn()``,
        which launches it ``launches`` times, by the profiler over
        ``runs`` calls: the mean over the launches it recorded, times
        ``launches`` (a sum over the calls undercounts when the window
        misses a launch); and the launches recorded and made. A window
        that recorded none of a call's launches (seen once for a 60 µs
        K8 call) is profiled again, up to ``windows`` windows; the
        windows taken are reported."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        for window in range(1, windows + 1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
            hits = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and kernel_name in e.key]
            recorded = sum(e.count for e in hits)
            if recorded > 0:
                break
        check(recorded > 0, f"the profiler recorded no {kernel_name} in "
              f"{windows} windows")
        return dict(device_ms=sum(e.self_device_time_total for e in hits)
                    / 1e3 / recorded * launches,
                    device_launches_recorded=recorded,
                    device_launches_made=runs * launches,
                    device_windows=window)

    def summed_bound(work):
        """The bounds of a sequence of calls, each ``(ops, bytes)``,
        summed: each call's own bound, and the operations' and bytes'
        times."""
        total = {"bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0}
        for o, nb in work:
            for k, v in bound(o, flops_peak, nb, bw_peak).items():
                if k in total:
                    total[k] += v
        return dict(total, bound_by="operations"
                    if total["ops_ms"] >= total["bytes_ms"] else "bytes",
                    gflop=sum(o for o, _ in work) / 1e9,
                    mbytes=sum(nb for _, nb in work) / 1e6)

    rows_k6 = []
    for path, calls in (
            ("wave, conv_backend=pallas, pool_backend=xla",
             cs_calls["wave"]),
            ("scan, conv_backend=pallas, pool_backend=fused",
             [c for c in cs_calls["scan"] if c[0] not in fused_nodes])):
        args = [(x, w, st) for _, x, w, st in calls]
        run_k6 = replay(args, lambda x, w, st: conv2d_stream_raw(
            x, w, stride=st))
        ms = median_ms(run_k6, groups=5, per_group=3)
        work = []
        for x, w, st in args:
            ho = (x.shape[1] - w.shape[0]) // st + 1
            wo = (x.shape[2] - w.shape[0]) // st + 1
            work.append(conv_work(x, w, st, x.shape[0] * ho * wo
                                  * w.shape[3]))
        b_k6 = summed_bound(work)
        rows_k6.append(dict(
            kernel="K6", path=path, launches_per_forward=len(args), ms=ms,
            **device_ms(run_k6, "conv_stream_kernel", len(args)),
            plain_ms=median_ms(replay(args, lambda x, w, st:
                                      conv2d_stream_plain(x, w, stride=st)),
                               groups=3, per_group=1, warm=1),
            library_ms=median_ms(replay(args, lambda x, w, st:
                                        conv2d_direct(x, w, st, 0)),
                                 groups=5, per_group=3),
            **b_k6, achieved_tflops=b_k6["gflop"] / ms))
        emit("timing", **rows_k6[-1], nvidia_smi=smi)

    k5_args = [(x, w, b, dict(stride=l.stride, pool=l.pool,
                              pool_stride=l.pool_stride or l.pool,
                              groups=l.groups))
               for _, x, w, b, l in fcp_calls]
    lib_args = [(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(),
                 b, kw) for x, w, b, kw in k5_args]

    def library_k5(x, w, b, kw):
        y = F.relu(F.conv2d(x, w, b, stride=kw["stride"],
                            groups=kw["groups"]))
        return F.max_pool2d(y, kw["pool"], kw["pool_stride"])

    work = []
    for _, x, w, b, l in fcp_calls:
        ps = l.pool_stride or l.pool
        # the natural (unpadded) input is what has to be read
        hp = (l.out_h - l.pool) // ps + 1
        wp_ = (l.out_w - l.pool) // ps + 1
        work.append((2 * BATCH * l.macs,
                     4 * (BATCH * l.in_h * l.in_w * l.in_c + w.numel()
                          + b.numel() + BATCH * hp * wp_ * l.out_c)))
    b_k5 = summed_bound(work)
    run_k5 = replay(k5_args, lambda x, w, b, kw: fused_conv_pool_raw(
        x, w, b, **kw))
    ms = median_ms(run_k5)
    row_k5 = dict(
        kernel="K5", path="wave or scan, pool_backend=fused (conv1, conv2, "
        "conv5)", launches_per_forward=len(k5_args), ms=ms,
        **device_ms(run_k5, "fused_conv_pool_kernel", len(k5_args)),
        plain_ms=median_ms(replay(k5_args, lambda x, w, b, kw:
                                  fused_conv_pool_plain(x, w, b, **kw)),
                           groups=5, per_group=2, warm=1),
        library_ms=median_ms(replay(lib_args, library_k5)), **b_k5,
        achieved_tflops=b_k5["gflop"] / ms)
    emit("timing", **row_k5, nvidia_smi=smi)

    # K7, K8 and K9 per public-op call on their paths' operands; no serving
    # path launches them (drive() checks it)
    def own_op_row(kernel, name, fn, plain_ms, library_ms, work, **extra):
        ms = median_ms(fn)
        return dict(kernel=kernel, case=name, ms=ms,
                    **device_ms(fn, kernel_names[kernel], 1),
                    plain_ms=plain_ms, library_ms=library_ms,
                    **bound(*work), launches_per_call=1,
                    launches_per_alexnet_forward=served_k789[kernel]
                    / served_k789["forwards"], **extra)

    kernel_names = {"K7": "maxpool_stream_kernel",
                    "K8": "quant_matmul_kernel",
                    "K9": "flash_attention_kernel"}
    rows_k7 = []
    for name, x, kw in mp_path:
        p, ps = kw["pool"], kw["stride"]
        ho, wo = (x.shape[1] - p) // ps + 1, (x.shape[2] - p) // ps + 1
        out_numel = x.shape[0] * ho * wo * x.shape[3]
        x_nchw = x.permute(0, 3, 1, 2)               # channels-last view
        rows_k7.append(own_op_row(
            "K7", name, lambda: maxpool_stream(x, **kw),
            median_ms(lambda: maxpool_stream_plain(x, **kw), groups=3,
                      per_group=1, warm=1),
            median_ms(lambda: F.max_pool2d(x_nchw, p, ps)),
            (out_numel * p * p, flops_peak,
             x.element_size() * (x.numel() + out_numel), bw_peak),
            library="F.max_pool2d on the channels-last NCHW view"))
        emit("timing", **rows_k7[-1], nvidia_smi=smi)
    rows_k8 = []
    for name, xq, wq, sx, sw in qmm_path:
        M, K = xq.shape
        N = wq.shape[1]
        # yardstick: torch._int_mm (which wants more than 16 rows, so the
        # head's 8 are padded to 32) and the same two scale multiplies
        a = F.pad(xq, (0, 0, 0, max(0, 32 - M))).contiguous()
        b = wq.t().contiguous().t()                  # column-major
        rows_k8.append(own_op_row(
            "K8", name, lambda: quant_matmul(xq, wq, sx, sw),
            median_ms(lambda: quant_matmul_plain(xq, wq, sx, sw),
                      groups=3, per_group=1, warm=1),
            median_ms(lambda: torch._int_mm(a, b).float() * sx
                      * sw[None, :]),
            (2 * M * N * K, INT8_PEAK_OPS,
             M * K + K * N + 4 + 4 * N + 4 * M * N, bw_peak),
            m_k_n=[M, K, N], library="torch._int_mm + 2 scale multiplies"
            + (f" (M padded {M} -> 32)" if M < 32 else "")))
        emit("timing", **rows_k8[-1], nvidia_smi=smi)
    rows_k9 = []
    for name, (q, k, v), kw, plain_ms in fa_path:
        B, H, S, D = q.shape
        T = k.shape[2]
        window = kw.get("window", 0)
        pairs = attention_pairs(S, T, kw["causal"], window)
        if window:
            qp = torch.arange(S, device=dev)[:, None]
            kp = torch.arange(T, device=dev)[None, :]
            mask = (kp <= qp) & (kp > qp - window)
            lib_kw = dict(attn_mask=mask)
        else:
            lib_kw = dict(is_causal=kw["causal"])
        rows_k9.append(own_op_row(
            "K9", name, lambda: flash_attention(q, k, v, **kw), plain_ms,
            median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True, **lib_kw)),
            (4 * B * H * D * pairs, flops_peak if q.dtype == torch.float32
             else BF16_PEAK_FLOPS,
             q.element_size() * (2 * q.numel() + 2 * k.numel()), bw_peak),
            pairs=pairs, library="F.scaled_dot_product_attention"
            + (" with a boolean window mask" if window else
               ", is_causal")))
        emit("timing", **rows_k9[-1], nvidia_smi=smi)

    for mode, cb, pb in (("wave", "xla", "xla"), ("wave", "pallas", "xla"),
                         ("wave", "pallas", "fused"),
                         ("scan", "pallas", "fused")):
        s, _ = served[(mode, cb, pb)]
        runs = profiled_runs if mode == "wave" else 2
        emit("timing", precision="fp32", mode=mode, conv_backend=cb,
             pool_backend=pb, **served_rate(serving(s), REQUESTS),
             batch=BATCH, requests_per_run=REQUESTS,
             profiled_requests=runs * REQUESTS,
             **profiled(serving(s), runs), nvidia_smi=smi)

    def entry(name, source, replaces, launches, err, rs):
        total = {k: sum(r[k] for r in rs)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                           "ops_ms", "bytes_ms")}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": total["ms"],
                "plain_ms": total["plain_ms"],
                "bound_ms": total["bound_ms"],
                "bound_by": "operations"
                if total["ops_ms"] >= total["bytes_ms"] else "bytes",
                "library_ms": total["library_ms"]}

    print(smi)
    print(json.dumps({"kernels": [
        entry("wave_replay_f32", "src/repro_torch/csrc/wave_replay.cu",
              "src/repro/kernels/wave_replay/kernel.py:40", launches,
              max_err, rows),
        # every K3 comparison above is torch.equal: no difference passes
        entry("wave_replay_q_i8", "src/repro_torch/csrc/wave_replay_q.cu",
              "src/repro/kernels/wave_replay_q/kernel.py:82", launches_q,
              0, rows_q),
        entry("wave_replay_graph_f32",
              "src/repro_torch/csrc/wave_replay_graph.cu",
              "src/repro/kernels/wave_replay/graph.py:157", n_g["K2"],
              max(err_g, err_sg), rows_g),
        # every K4 comparison above is torch.equal
        entry("wave_replay_graph_q_i8",
              "src/repro_torch/csrc/wave_replay_graph_q.cu",
              "src/repro/kernels/wave_replay_q/graph.py:180", n_gq["K4"],
              0, rows_gq),
        # launches: the wave path with a fused pool (K5) and with the
        # direct pool (K6, whose ms row is that path's forward)
        entry("fused_conv_pool_f32",
              "src/repro_torch/csrc/fused_conv_pool.cu",
              "src/repro/kernels/fused_conv_pool/kernel.py:24",
              served[("wave", "pallas", "fused")][1]["K5"],
              max(err_fcp, err_served["K5"]), [row_k5]),
        entry("conv_stream_f32", "src/repro_torch/csrc/conv_stream.cu",
              "src/repro/kernels/conv_stream/kernel.py:29",
              served[("wave", "pallas", "xla")][1]["K6"],
              max(err_cs, err_served["K6"]), rows_k6[:1]),
        # K7, K8: every comparison above is equality; launches and times
        # over each one's path (AlexNet's three pools, four int8 gemms;
        # K9: the Qwen3 prefill at fp32 and bf16 and the Gemma3 layer)
        entry("maxpool_stream", "src/repro_torch/csrc/maxpool_stream.cu",
              "src/repro/kernels/maxpool_stream/kernel.py:20", launches_mp,
              0, rows_k7),
        entry("quant_matmul_i8", "src/repro_torch/csrc/quant_matmul.cu",
              "src/repro/kernels/quant_matmul/kernel.py:19", launches_qmm,
              0, rows_k8),
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:25", launches_fa,
              err_fa, rows_k9)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
