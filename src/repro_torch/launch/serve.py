"""Serve single-image CNN requests through a ``StreamingSession``.

  PYTHONPATH=src python -m repro_torch.launch.serve --network alexnet \
      --batch 8 --requests 32 [--precision fp32|int8] \
      [--mode megakernel|graphkernel|wave|scan] [--pool-backend xla|fused] \
      [--device cuda|cpu]

The chosen network's graph (core/model_zoo.py) is planned and lowered
once; every ``--batch`` submits share one batched forward: one kernel
launch per conv node (``--mode megakernel``, the default: K1 at fp32, K3
at int8), one per fused chain of conv nodes (``--mode graphkernel``: K2
at fp32, K4 at int8; a single-node chain takes K1/K3), or the layer
executors at fp32 (``--mode wave``, the reference's default, or ``--mode
scan``), with ``--pool-backend fused`` running each pooled conv node
through the fused conv + ReLU + pool kernel K5 (ignored by the megakernel
modes, whose kernels fuse the pool). The per-step conv of wave and scan
mode is the session's ``conv_backend``, which the command leaves at the
direct conv, as the reference's does. Weights are random, He-normal from
``--seed``. ``--precision int8`` first calibrates the graph on two seeded
random images. Prints the first flush's time, the served rate,
``compiles=``, ``batched calls=`` and the launches of each kernel.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.model_zoo import network_graph
from repro_torch.kernels.conv_stream import kernel as k6
from repro_torch.kernels.fused_conv_pool import kernel as k5
from repro_torch.kernels.wave_replay import graph as k2
from repro_torch.kernels.wave_replay import kernel as k1
from repro_torch.kernels.wave_replay_q import graph as k4
from repro_torch.kernels.wave_replay_q import kernel as k3
from repro_torch.launch.session import StreamingSession, resolve_device
from repro_torch.models.cnn import init_graph_weights
from repro_torch.quant.calibrate import calibrate_graph


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cnn_main(args) -> None:
    device = resolve_device(args.device)
    graph = network_graph(args.network)
    gen = torch.Generator().manual_seed(args.seed)
    weights = init_graph_weights(graph, gen, device)
    H, W, C = graph.in_shape
    qnet = None
    if args.precision == "int8":
        calib = torch.randn((2, H, W, C),
                            generator=torch.Generator().manual_seed(7))
        qnet = calibrate_graph(graph, weights, calib.to(device))
    kernels = {"K1": k1, "K2": k2, "K3": k3, "K4": k4, "K5": k5, "K6": k6}
    sess = StreamingSession.for_graph(graph, weights,
                                      sram_budget=args.sram_kb * 1024,
                                      max_batch=args.batch, device=device,
                                      mode=args.mode,
                                      pool_backend=args.pool_backend,
                                      precision=args.precision, qnet=qnet)
    imgs = torch.randn((args.requests, H, W, C), generator=gen).to(device)

    t0 = time.perf_counter()      # one padded flush builds the forward
    sess.result(sess.submit(imgs[0]))
    _sync(device)
    print(f"compile+first flush: {time.perf_counter() - t0:.3f} s")

    for k in kernels.values():
        k.reset_launch_count()
    calls0 = sess.calls
    t0 = time.perf_counter()
    tickets = [sess.submit(imgs[i]) for i in range(args.requests)]
    sess.flush()
    for t in tickets:
        sess.result(t)
    _sync(device)
    dt = time.perf_counter() - t0
    calls = sess.calls - calls0
    counts = ", ".join(f"{name} {k.launch_count()}/{k.plain_count()}"
                       for name, k in kernels.items()
                       if k.launch_count() or k.plain_count())
    print(f"served {args.requests} requests in {dt * 1e3:.1f} ms "
          f"({args.requests / dt:.1f} img/s) on {device}, "
          f"compiles={sess.compile_count}, batched calls={calls}, "
          f"{args.mode} {args.precision}: kernel launches/plain-version "
          f"runs: {counts or 'none'} "
          f"({sess.health()['launches_per_forward_by_kernel']} per call)")
    print(sess.describe())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--network", default="alexnet")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--sram-kb", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", choices=("fp32", "int8"), default="fp32")
    ap.add_argument("--mode", choices=("megakernel", "graphkernel", "wave",
                                       "scan"), default="megakernel")
    ap.add_argument("--pool-backend", choices=("xla", "fused"),
                    default="xla",
                    help="wave/scan: run pooled conv nodes through the "
                         "fused conv+ReLU+pool kernel (K5)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    cnn_main(ap.parse_args(argv))


if __name__ == "__main__":
    main()
