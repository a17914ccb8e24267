"""Serve single-image CNN requests through a ``StreamingSession``.

  PYTHONPATH=src python -m repro_torch.launch.serve --network alexnet \
      --batch 8 --requests 32 [--device cuda|cpu]

The chosen network's graph (core/model_zoo.py) is planned and lowered
once; every ``--batch`` submits share one batched forward of one kernel
launch per conv node. Weights are random, He-normal from ``--seed``.
Prints the first flush's time, the served rate, ``compiles=``,
``batched calls=`` and the kernel launches.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.model_zoo import network_graph
from repro_torch.kernels.wave_replay.ops import (launch_count, plain_count,
                                                 reset_launch_count)
from repro_torch.launch.session import StreamingSession, resolve_device
from repro_torch.models.cnn import init_graph_weights


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cnn_main(args) -> None:
    device = resolve_device(args.device)
    graph = network_graph(args.network)
    gen = torch.Generator().manual_seed(args.seed)
    weights = init_graph_weights(graph, gen, device)
    sess = StreamingSession.for_graph(graph, weights,
                                      sram_budget=args.sram_kb * 1024,
                                      max_batch=args.batch, device=device)
    H, W, C = graph.in_shape
    imgs = torch.randn((args.requests, H, W, C), generator=gen).to(device)

    t0 = time.perf_counter()      # one padded flush builds the forward
    sess.result(sess.submit(imgs[0]))
    _sync(device)
    print(f"compile+first flush: {time.perf_counter() - t0:.3f} s")

    reset_launch_count()
    calls0 = sess.calls
    t0 = time.perf_counter()
    tickets = [sess.submit(imgs[i]) for i in range(args.requests)]
    sess.flush()
    for t in tickets:
        sess.result(t)
    _sync(device)
    dt = time.perf_counter() - t0
    calls = sess.calls - calls0
    print(f"served {args.requests} requests in {dt * 1e3:.1f} ms "
          f"({args.requests / dt:.1f} img/s) on {device}, "
          f"compiles={sess.compile_count}, batched calls={calls}, "
          f"kernel launches={launch_count()} "
          f"plain-version runs={plain_count()} "
          f"({len(sess.programs)} per call)")
    print(sess.describe())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--network", default="alexnet")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--sram-kb", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    cnn_main(ap.parse_args(argv))


if __name__ == "__main__":
    main()
