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
5. ``quant``: entry quantization on the card equals it on the CPU at
   exact halves of the scale.
6. ``serve``: serve 32 AlexNet requests at batch 8 through the port's
   fp32 ``StreamingSession`` on the card, with the launch counts set to 0
   just before and read just after; the outputs are held against the
   port's direct reference on the card (TF32 off for matmul and cuDNN).
7. ``serve_q``: calibrate AlexNet on the card, serve the same 32 requests
   through the int8 session (K3 five times per batched call, K1 never),
   hold its raw int8 output bit for bit against the port's int32
   reference walk on the card, and report the SNR of the dequantized
   output against the fp32 reference.
8. ``timing``: per AlexNet layer at batch 8, each kernel's median time,
   its plain version's, a library yardstick the port never calls
   (``library_ms``: cuDNN's ``conv2d + bias + ReLU + max_pool2d`` for K1,
   ``torch._int_mm`` on the layer's im2col, per group, gemm only, for K3)
   and the bound; for each precision the served images per second over
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

# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): fp32
# outside the tensor cores, dense int8 on the tensor cores, and memory
# bandwidth.
H100_SXM = "H100 80GB HBM3"
FP32_PEAK_FLOPS = 67.0e12
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
                                            compile_graph,
                                            graph_kernel_programs,
                                            plan_graph, run_graph_reference)
    from repro_torch.kernels import _build
    from repro_torch.kernels.wave_replay import ops
    from repro_torch.kernels.wave_replay.kernel import (launch_geometry,
                                                        wave_replay_raw)
    from repro_torch.kernels.wave_replay.ref import (fp32_error,
                                                     wave_replay_plain)
    from repro_torch.kernels.wave_replay_q import ops as ops_q
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
         int8_peak_ops=INT8_PEAK_OPS, mem_bytes_per_s=bw_peak)

    # 2. build: one nvcc per source, all started together
    stems = ("wave_replay", "wave_replay_q")
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

    # 5. entry quantization: the card rounds as the CPU does at ties
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

    # 6. the fp32 main path: serve AlexNet requests through the session
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

    def drive(s):
        """One 32-request run with both kernels' counts set to 0 just
        before and read just after."""
        ops.reset_launch_count()
        ops_q.reset_launch_count()
        calls0 = s.calls
        t0 = time.perf_counter()
        outs = serving(s)()
        return (outs, time.perf_counter() - t0, s.calls - calls0,
                ops.launch_count(), ops_q.launch_count())

    outs, first_s, calls, launches, stray_q = drive(sess)
    check(calls == REQUESTS // BATCH, f"{calls} batched calls")
    check(launches == 5 * calls and stray_q == 0,
          f"{launches} K1 and {stray_q} K3 launches for {calls} fp32 "
          f"AlexNet calls")
    y = torch.stack(outs)
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

    # 7. the int8 main path: calibrate on the card, serve the same requests
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
    outs, first_q_s, calls_q, stray, launches_q = drive(sess_q)
    check(calls_q == REQUESTS // BATCH, f"{calls_q} batched int8 calls")
    check(launches_q == 5 * calls_q and stray == 0,
          f"{launches_q} K3 and {stray} K1 launches for {calls_q} int8 "
          f"AlexNet calls")
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

    # 8. timing, per AlexNet layer at batch 8, and the served rates
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
    profiled_runs = 4
    for precision, s in (("fp32", sess), ("int8", sess_q)):
        emit("timing", precision=precision,
             **served_rate(serving(s), REQUESTS), batch=BATCH,
             requests_per_run=REQUESTS,
             profiled_requests=profiled_runs * REQUESTS,
             **profiled(serving(s), profiled_runs), nvidia_smi=smi)

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
              0, rows_q)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
