#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``card``: the card's name and power limit (``nvidia-smi``), and what
   PyTorch sees.
2. ``build``: compile the port's kernel source with ``nvcc``
   (``-Xptxas -v`` report included) and time it.
3. ``kernel``: hold the wave-replay kernel (K1) against its plain PyTorch
   version on the same CUDA tensors, one phase per branch: AlexNet's five
   layers at 227x227 and batch 8 (dense, grouped, fused 3/2 pool), a
   residual node of ResNet-18, a depthwise node of MobileNet-v1, a
   depthwise layer with a channel multiplier, and a ``vmem_budget=None``
   layer with a multi-tile grid and a multi-step chain.
4. ``serve``: serve 32 AlexNet requests at batch 8 through the port's
   ``StreamingSession`` on the card, with the launch count set to 0 just
   before and read just after; the outputs are held against the port's
   direct reference on the card (TF32 off for matmul and cuDNN).
5. ``timing``: per AlexNet layer at batch 8, the kernel's median time,
   the plain version's, cuDNN's ``conv2d + bias + ReLU + max_pool2d``
   (``library_ms``, a yardstick the port never calls) and the bound; the
   served images per second over windows of at least a second; and, from
   ``torch.profiler`` over served runs, the device time by kernel, the
   device's idle share and the host time by operation.

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
# outside the tensor cores, and memory bandwidth.
H100_SXM = "H100 80GB HBM3"
FP32_PEAK_FLOPS = 67.0e12
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
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import decomposition as dec
    from repro_torch.core.model_zoo import network_graph
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
    from repro_torch.launch.session import StreamingSession
    from repro_torch.models.cnn import init_graph_weights

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
         mem_bytes_per_s=bw_peak)

    # 2. build
    t0 = time.perf_counter()
    report = _build.build("wave_replay")
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=report["seconds"],
         ptxas=[ln for ln in report["log"].splitlines()
                if "registers" in ln or "spill" in ln])

    # 3. the kernel against its plain version, one phase per branch
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
        if name.startswith("alexnet.conv") and " " not in name:
            layer_ops[name.split(".")[1]] = (kp, natural,
                                             (xp, wp, bias, table, rp))

    # 4. the main path: serve AlexNet requests through the session
    weights = init_graph_weights(alex, torch.Generator().manual_seed(1),
                                 dev)
    sess = StreamingSession.for_graph(alex, weights, max_batch=BATCH,
                                      device=dev)
    imgs = torch.randn((REQUESTS,) + alex.in_shape,
                       generator=torch.Generator().manual_seed(2)).to(dev)
    sess.result(sess.submit(imgs[0]))         # builds the batch-8 forward
    torch.cuda.synchronize()

    def serve():
        tickets = [sess.submit(imgs[i]) for i in range(REQUESTS)]
        sess.flush()
        outs = [sess.result(t) for t in tickets]
        torch.cuda.synchronize()
        return outs

    ops.reset_launch_count()
    calls0 = sess.calls
    t0 = time.perf_counter()
    outs = serve()
    first_s = time.perf_counter() - t0
    launches = ops.launch_count()
    calls = sess.calls - calls0
    check(calls == REQUESTS // BATCH, f"{calls} batched calls")
    check(launches == 5 * calls,
          f"{launches} kernel launches for {calls} AlexNet calls")
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

    # 5. timing, per AlexNet layer at batch 8, and the served rate
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
        bound_ms = max(flops / flops_peak, nbytes / bw_peak) * 1e3
        rows.append(dict(layer=name, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by="operations"
                         if flops / flops_peak >= nbytes / bw_peak
                         else "bytes",
                         ops_ms=flops / flops_peak * 1e3,
                         bytes_ms=nbytes / bw_peak * 1e3,
                         gflop=flops / 1e9, mbytes=nbytes / 1e6,
                         achieved_tflops=flops / ms / 1e9,
                         launches_per_forward=1))
        emit("timing", **rows[-1], nvidia_smi=smi)
    # served rate: windows of whole 32-request runs lasting at least
    # SERVE_WINDOW_S each, back to back
    windows = []
    for _ in range(SERVE_WINDOWS):
        runs = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < SERVE_WINDOW_S:
            serve()
            runs += 1
        dt = time.perf_counter() - t0
        windows.append({"seconds": dt, "requests": runs * REQUESTS,
                        "img_per_s": runs * REQUESTS / dt})
    rates = [w["img_per_s"] for w in windows]
    # where served time goes, under torch.profiler over four runs: device
    # time by kernel over the wall time (the rest the device waits on the
    # host), and the host's time by operation (self time; what no
    # operation holds is Python between operations)
    profiled_runs = 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled_runs):
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
    emit("timing", served_img_per_s=statistics.median(rates),
         served_img_per_s_min=min(rates), served_img_per_s_max=max(rates),
         windows=windows, batch=BATCH, requests_per_run=REQUESTS,
         profiled_requests=profiled_runs * REQUESTS,
         profiled_wall_ms=wall_ms,
         device_busy_ms=busy_ms if by_kernel else None,
         device_idle_share=1 - busy_ms / wall_ms if by_kernel else None,
         device_ms_by_kernel=dict(sorted(by_kernel.items(),
                                         key=lambda kv: -kv[1])[:8]),
         host_ops_ms=host_ops_ms, host_between_ops_ms=wall_ms - host_ops_ms,
         host_ms_by_op=dict(sorted(by_op.items(),
                                   key=lambda kv: -kv[1])[:10]),
         nvidia_smi=smi)

    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "ops_ms", "bytes_ms")}
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "wave_replay_f32",
        "route": "cuda",
        "source": "src/repro_torch/csrc/wave_replay.cu",
        "replaces": "src/repro/kernels/wave_replay/kernel.py:40",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "operations" if total["ops_ms"] >= total["bytes_ms"]
        else "bytes",
        "library_ms": total["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
