"""Streaming sessions: batched multi-image CNN serving on the card.

The counterpart of ``repro/launch/session.py``. The session takes a
``NetworkGraph`` (or a plain layer sequence, wrapped into its chain
graph), plans and lowers every conv node once at construction, and
serves each request batch with one forward of the chosen executor mode:

  * ``mode="megakernel"`` (the port's default): ONE wave-replay kernel
    launch per conv node (K1 at fp32, K3 at int8);
  * ``mode="graphkernel"``: ONE launch per fused chain of conv nodes (K2
    at fp32, K4 at int8; a single-node chain takes the per-layer kernel);
  * ``mode="wave"`` (the reference's default) and ``mode="scan"``: the
    layer executors at fp32, with ``conv_backend="pallas"`` running every
    single-group wave or step conv through the streaming conv kernel K6,
    and ``pool_backend="fused"`` every pooled, ReLU'd conv node through
    the fused conv + ReLU + pool kernel K5 (one launch per node, its conv
    groups inside). Grouped wave dispatches and scan steps run the direct
    grouped conv, as the reference runs them outside its kernels.

Per batch shape the session builds the forward and uploads the operand
tables once (``compile_count``), then replays them for every call.

  * ``run_batch(x)`` — synchronous batched inference.
  * ``submit(img)`` / ``result(ticket)`` — micro-batching queue: single
    images coalesce into one ``max_batch`` call; partial batches are
    zero-padded so the batch shape, and its tables, stay the same.

The session runs on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do), where each kernel's plain version runs instead. With no
card and no device named it raises; it never moves to the CPU itself.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.decomposition import ConvLayer, plan_decomposition
from repro_torch.core.graph import (INPUT, NetworkGraph, chain_graph,
                                    conv_keyed)
from repro_torch.core.schedule import TileProgram
from repro_torch.core.streaming import (_partition_waves_cached,
                                        check_mode, compile_graph,
                                        graph_chain_programs,
                                        graph_forward_fn, graph_operands,
                                        plan_graph)
from repro_torch.core.quantization import quantize_int8_sym
from repro_torch.kernels.conv_stream import kernel as k6
from repro_torch.kernels.fused_conv_pool import kernel as k5
from repro_torch.kernels.wave_replay import graph as k2
from repro_torch.kernels.wave_replay import kernel as k1
from repro_torch.kernels.wave_replay_q import graph as k4
from repro_torch.kernels.wave_replay_q import kernel as k3
from repro_torch.quant.calibrate import quantized_graph_from_network
from repro_torch.runtime.errors import DeadlineExceeded, Overloaded

# Session options of the reference that this package does not run yet.
_NOT_PORTED = {
    "fallback": "queue 1 item 8 (degradation runtime)",
    "guard": "queue 1 item 8 (degradation runtime)",
    "tracer": "the obs slice (span tracing and metrics)",
}


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless a device is named; raises when ``cuda`` is asked
    for (or implied) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the session runs on the card "
            "unless device='cpu' is passed")
    return dev


def _kernel_runs() -> Dict[str, int]:
    """K5 and K6 runs so far: CUDA launches plus plain-version runs."""
    return {"K5": k5.launch_count() + k5.plain_count(),
            "K6": k6.launch_count() + k6.plain_count()}


class StreamingSession:
    """One (graph, plan-set) serving session, one forward per batch shape.

    ``mode`` is ``"megakernel"`` (default), ``"graphkernel"``,
    ``"wave"`` or ``"scan"`` (alias ``"jit"``); the reference defaults to
    ``"wave"``, the port to the mode whose every conv runs a hand-written
    kernel. ``mode="interpret"`` has no compiled forward and raises
    ``ValueError``, as in the reference. ``mode="auto"``, ``fallback``,
    ``guard`` and ``tracer`` raise ``NotImplementedError`` naming the
    ROADMAP item that ports them.

    In wave and scan mode, ``conv_fn`` (a callable ``(x_tile, w_tile) ->
    y_tile``) or ``conv_backend`` (``"xla"``: the direct conv;
    ``"pallas"``: kernel K6) is the per-step conv, and
    ``pool_backend="fused"`` serves pooled, ReLU'd conv nodes through
    kernel K5. The megakernel modes ignore all three, as the reference
    does.

    ``precision="int8"`` serves the fixed-point datapath: pass a
    calibrated ``qnet``, a ``QuantizedGraph`` (``quant/calibrate.py``) or,
    for a chain graph, a ``QuantizedNetwork``; ``weights`` may then be
    ``None``. Float requests are quantized at entry and int8 requests
    taken as the input's codes; outputs are dequantized at exit unless
    ``dequantize=False``, which returns the raw int8 codes.

    Kernel programs are lowered at ``max_batch`` as the reference lowers
    them, so the operand tables are the reference's. ``max_pending``
    bounds the queue (``submit`` raises ``Overloaded`` when full);
    ``submit(..., deadline=s)`` drops a request still queued ``s``
    seconds later.
    """

    def __init__(self, graph, plans, weights, max_batch: int = 8,
                 mode: str = "megakernel", precision: str = "fp32",
                 device=None, qnet=None, dequantize: bool = True,
                 max_pending: Optional[int] = None,
                 validate_inputs: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 fallback=None, guard=None, tracer=None,
                 conv_fn: Optional[Callable] = None,
                 conv_backend: str = "xla", pool_backend: str = "xla"):
        for name, value in (("fallback", fallback), ("guard", guard),
                            ("tracer", tracer)):
            if value is not None and value is not False:
                raise NotImplementedError(
                    f"{name}= is not ported yet: ROADMAP "
                    f"{_NOT_PORTED[name]}")
        if mode == "auto":
            raise NotImplementedError(
                "mode='auto' is not ported yet: ROADMAP queue 1 item 9 "
                "(autotuner)")
        if check_mode(mode, precision) == "interpret":
            raise ValueError("interpret mode has no operand tables: a "
                             "session serves a compiled mode")
        if conv_backend not in ("xla", "pallas"):
            raise ValueError(f"unknown conv backend {conv_backend!r} "
                             f"(expected xla | pallas)")
        if pool_backend not in ("xla", "fused"):
            raise ValueError(f"unknown pool backend {pool_backend!r} "
                             f"(expected xla | fused)")
        self.conv_fn = conv_fn
        self.conv_backend = conv_backend
        self.pool_backend = pool_backend
        if not isinstance(graph, NetworkGraph):
            graph = chain_graph(tuple(graph))
        self.graph = graph
        self.device = resolve_device(device)
        self.layers = tuple(n.layer for n in graph.conv_nodes())
        self._plans = conv_keyed(graph, plans, "plans")
        self.plans = tuple(self._plans.values())
        self.max_batch = int(max_batch)
        self.mode = mode
        self.precision = precision
        self._progs = compile_graph(graph, self._plans)
        self.programs: List[TileProgram] = list(self._progs.values())
        self.dequantize = bool(dequantize)
        if precision == "int8":
            if qnet is None:
                raise ValueError(
                    "precision='int8' needs a calibrated qnet: run "
                    "repro_torch.quant.calibrate.calibrate_graph (or "
                    "calibrate_network for a linear stack) first")
            if not hasattr(qnet, "scales"):      # QuantizedNetwork
                if tuple(qnet.layers) != self.layers:
                    raise ValueError(
                        "qnet was calibrated for a different layer stack")
                qnet = quantized_graph_from_network(qnet, graph)
            if qnet.graph != graph:
                raise ValueError("qnet was calibrated for a different graph")
            # (wq, bias_q, m, shift) per node; float weights are not needed
            self.weights = qnet.device_weights(self.device)
        else:
            if weights is None:
                raise ValueError(
                    "weights=None is only valid with precision='int8' "
                    "(where the calibrated qnet supplies them)")
            self.weights = {
                name: (w.to(self.device, torch.float32).contiguous(),
                       None if b is None
                       else b.to(self.device, torch.float32).contiguous())
                for name, (w, b) in conv_keyed(graph, weights,
                                               "weights").items()}
        self.qnet = qnet
        self.max_pending = max_pending
        self.validate_inputs = bool(validate_inputs)
        self._clock = clock
        self.shed = 0                   # requests rejected (queue full)
        self.deadline_expired = 0       # requests dropped past deadline
        self._executables: Dict[tuple, tuple] = {}
        self.compile_count = 0          # forwards built + tables uploaded
        self.calls = 0                  # batched forward invocations
        # (ticket, image, expiry | None)
        self._pending: List[Tuple[int, torch.Tensor, Optional[float]]] = []
        self._results: Dict[int, torch.Tensor] = {}
        self._expired: set = set()
        self._next_ticket = 0
        self._chain_lowering = None
        # K5/K6 runs (launches or plain-version runs) of the last forward
        # in wave and scan mode, counted as they happen
        self._last_runs: Optional[Dict[str, int]] = None

    @classmethod
    def for_network(cls, layers: Sequence[ConvLayer], weights,
                    sram_budget: int = 128 * 1024,
                    **kw) -> "StreamingSession":
        """Plan every layer under one buffer budget, then build a
        session over the stack's chain graph."""
        plans = [plan_decomposition(l, sram_budget) for l in layers]
        return cls(tuple(layers), plans, weights, **kw)

    @classmethod
    def for_graph(cls, graph: NetworkGraph, weights,
                  sram_budget: int = 128 * 1024,
                  **kw) -> "StreamingSession":
        """Plan every conv node under one buffer budget, then build the
        session."""
        return cls(graph, plan_graph(graph, sram_budget), weights, **kw)

    # ------------------------------------------------------------------
    # batched path
    # ------------------------------------------------------------------
    def _exec_key(self, shape, dtype) -> tuple:
        return (tuple(shape), str(dtype), self.mode, self.precision)

    def _executable(self, key: tuple):
        """(forward, operand tables) for one batch shape: lowered once,
        tables uploaded once."""
        if key not in self._executables:
            fwd = graph_forward_fn(self.graph, self._progs, self.mode,
                                   precision=self.precision,
                                   qgraph=self.qnet,
                                   dequantize=self.dequantize,
                                   batch=self.max_batch,
                                   conv_fn=self.conv_fn,
                                   conv_backend=self.conv_backend,
                                   pool_backend=self.pool_backend)
            ops = graph_operands(self.graph, self._progs, self.mode,
                                 precision=self.precision,
                                 batch=self.max_batch, device=self.device)
            self._executables[key] = (fwd, ops)
            self.compile_count += 1
        return self._executables[key]

    def check_input(self, x, batched: bool = True) -> None:
        """Reject a request whose shape, dtype or content can't be
        served; the error names the expected spec."""
        H, W, C = self.graph.in_shape
        spec = f"(B, {H}, {W}, {C})" if batched else f"({H}, {W}, {C})"
        what = "run_batch" if batched else "submit"
        want_nd = 4 if batched else 3
        if getattr(x, "ndim", None) != want_nd \
                or tuple(x.shape[-3:]) != (H, W, C):
            raise ValueError(
                f"{self.graph.name}.{what}: expected {spec} "
                f"{self.graph.dtype} input, got shape "
                f"{tuple(getattr(x, 'shape', ()))}")
        t = torch.as_tensor(x)
        codes = self._is_codes(t)
        if not (t.dtype.is_floating_point or codes):
            raise ValueError(
                f"{self.graph.name}.{what}: expected {spec} "
                f"{self.graph.dtype} input, got dtype {t.dtype}")
        if not codes and not bool(torch.isfinite(t).all()):
            raise ValueError(
                f"{self.graph.name}.{what}: input contains NaN/Inf — "
                f"refusing to serve (expected finite {spec} "
                f"{self.graph.dtype})")

    def run_batch(self, x) -> torch.Tensor:
        """(B, H, W, C) -> network output on the session's device."""
        if self.validate_inputs:
            self.check_input(x, batched=True)
        x = torch.as_tensor(x).to(self.device)
        if not self._is_codes(x):
            x = x.to(torch.float32)
        fwd, ops = self._executable(self._exec_key(x.shape, x.dtype))
        self.calls += 1
        if self.mode not in ("wave", "scan"):
            return fwd(x, self.weights, ops)
        before = _kernel_runs()
        y = fwd(x, self.weights, ops)
        self._last_runs = {k: n - before[k]
                           for k, n in _kernel_runs().items()}
        return y

    def _is_codes(self, x: torch.Tensor) -> bool:
        return self.precision == "int8" and x.dtype == torch.int8

    def _stack(self, images: List[torch.Tensor]) -> torch.Tensor:
        """Queued images as one batch: fp32, or int8 codes on an int8
        session. Float images are quantized at entry, elementwise as the
        forward would: once for the batch, or one by one when the batch
        mixes them with int8 codes."""
        imgs = [im.to(self.device) for im in images]
        if self.precision != "int8":
            return torch.stack([im.to(torch.float32) for im in imgs])
        scale = self.qnet.scales[INPUT]
        if not any(self._is_codes(im) for im in imgs):
            return quantize_int8_sym(torch.stack(imgs), scale)
        return torch.stack([im if self._is_codes(im)
                            else quantize_int8_sym(im, scale)
                            for im in imgs])

    # ------------------------------------------------------------------
    # micro-batching queue: single-image requests share one batched call
    # ------------------------------------------------------------------
    def submit(self, image, deadline: Optional[float] = None) -> int:
        """Enqueue one (H, W, C) image; returns a ticket for result().

        Flushes whenever ``max_batch`` requests are pending. A full
        queue (``max_pending``) sheds the request with ``Overloaded``.
        ``deadline`` is a budget in seconds: a request still queued when
        it expires is dropped at the next flush and its ``result()``
        raises ``DeadlineExceeded``."""
        if self.validate_inputs:
            self.check_input(image, batched=False)
        elif getattr(image, "ndim", None) != 3:
            raise ValueError(f"submit() wants (H, W, C), got {image.shape}")
        if self.max_pending is not None \
                and len(self._pending) >= self.max_pending:
            self.shed += 1
            raise Overloaded(
                f"{self.graph.name}: pending queue full "
                f"({len(self._pending)}/{self.max_pending}) — request "
                f"shed; retry after a flush")
        ticket = self._next_ticket
        self._next_ticket += 1
        expiry = None if deadline is None else self._clock() + deadline
        self._pending.append((ticket, torch.as_tensor(image), expiry))
        if len(self._pending) >= self.max_batch:
            self.flush()
        return ticket

    def flush(self) -> None:
        """Run all live pending requests as one (zero-padded) batch;
        requests past their deadline are dropped here."""
        if not self._pending:
            return
        now = self._clock()
        live = []
        for t, im, exp in self._pending:
            if exp is not None and now > exp:
                self._expired.add(t)
                self.deadline_expired += 1
            else:
                live.append((t, im))
        self._pending.clear()
        if not live:
            return
        imgs = self._stack([im for _, im in live])
        n = imgs.shape[0]
        if n < self.max_batch:
            # zero rows keep the session's batch shape; discarded below
            imgs = torch.cat([imgs, imgs.new_zeros(
                (self.max_batch - n,) + tuple(imgs.shape[1:]))])
        out = self.run_batch(imgs)
        for i, (t, _) in enumerate(live):
            self._results[t] = out[i]

    def result(self, ticket: int) -> torch.Tensor:
        """Fetch (and forget) one request's output; flushes if pending."""
        if ticket not in self._results:
            self.flush()
        if ticket in self._expired:
            self._expired.discard(ticket)
            raise DeadlineExceeded(
                f"ticket {ticket}: dropped — its deadline passed while "
                f"queued")
        if ticket not in self._results:
            raise KeyError(
                f"ticket {ticket}: unknown, already fetched, or discarded")
        return self._results.pop(ticket)

    def discard(self, ticket: int) -> None:
        """Drop a pending or completed request without fetching it."""
        self._pending = [p for p in self._pending if p[0] != ticket]
        self._results.pop(ticket, None)
        self._expired.discard(ticket)

    @property
    def pending(self) -> int:
        return len(self._pending)

    def chains(self):
        """``(chains, kprogs, gkps)`` of the graphkernel lowering at
        ``max_batch`` (``graph_chain_programs``), the partition the
        forward replays; ``None`` in megakernel mode."""
        if self.mode != "graphkernel":
            return None
        if self._chain_lowering is None:
            self._chain_lowering = graph_chain_programs(
                self.graph, self._progs, quantized=self.precision == "int8",
                batch=self.max_batch)
        return self._chain_lowering

    def kernel_launches_per_forward(self) -> Optional[Dict[str, int]]:
        """Launches of each hand-written kernel in one forward: from the
        lowered programs in megakernel mode (K1/K3 per conv node) and
        graphkernel mode (K2/K4 per multi-node chain, K1/K3 per
        single-node chain); in wave and scan mode the K5 and K6 runs
        counted over the last forward (``None`` before the first), so
        they are what the executors dispatched."""
        per_layer, chain = (("K3", "K4") if self.precision == "int8"
                            else ("K1", "K2"))
        if self.mode == "megakernel":
            return {per_layer: len(self.programs)}
        lowered = self.chains()
        if lowered is not None:
            chains, _, gkps = lowered
            return {chain: len(gkps), per_layer: len(chains) - len(gkps)}
        return None if self._last_runs is None else dict(self._last_runs)

    def health(self) -> dict:
        """Machine-readable serving health: mode, backends, device, the
        executor of each conv node, the launches of each hand-written
        kernel in one forward and their total (``kernel_launches_per_
        forward``), and the session's counters."""
        lowered = self.chains()
        if lowered is None:
            node_modes = {name: self.mode for name in self._progs}
        else:
            chains, _, gkps = lowered
            node_modes = {name: ("graphkernel" if c.convs[0] in gkps
                                 else "megakernel")
                          for c in chains for name in c.convs}
        by_kernel = self.kernel_launches_per_forward()
        return {
            "graph": self.graph.name,
            "mode": self.mode,
            "precision": self.precision,
            "conv_backend": self.conv_backend,
            "pool_backend": self.pool_backend,
            "device": str(self.device),
            "node_modes": node_modes,
            "launches_per_forward": (None if by_kernel is None
                                     else sum(by_kernel.values())),
            "launches_per_forward_by_kernel": by_kernel,
            "counters": {
                "shed": self.shed,
                "deadline_expired": self.deadline_expired,
                "compiles": self.compile_count,
                "calls": self.calls,
                "kernel_launches": k1.launch_count(),
                "plain_calls": k1.plain_count(),
                "kernel_launches_q": k3.launch_count(),
                "plain_calls_q": k3.plain_count(),
                "kernel_launches_graph": k2.launch_count(),
                "plain_calls_graph": k2.plain_count(),
                "kernel_launches_graph_q": k4.launch_count(),
                "plain_calls_graph_q": k4.plain_count(),
                "kernel_launches_fused_conv_pool": k5.launch_count(),
                "plain_calls_fused_conv_pool": k5.plain_count(),
                "kernel_launches_conv_stream": k6.launch_count(),
                "plain_calls_conv_stream": k6.plain_count(),
            },
            "pending": len(self._pending),
            "executables": len(self._executables),
        }

    def describe(self) -> str:
        backends = ("" if self.mode in ("megakernel", "graphkernel")
                    else f"conv_backend={self.conv_backend}, "
                         f"pool_backend={self.pool_backend}, "
                         f"launches per forward "
                         f"{self.kernel_launches_per_forward()}, ")
        lines = [f"StreamingSession[{self.graph.name}]: "
                 f"{len(self.graph.nodes)} nodes "
                 f"({len(self.programs)} conv), "
                 f"mode={self.mode}, precision={self.precision}, "
                 f"{backends}device={self.device}, "
                 f"max_batch={self.max_batch}, "
                 f"executables={len(self._executables)}, "
                 f"compiles={self.compile_count}, calls={self.calls}"]
        lowered = self.chains()
        if lowered is not None:
            chains, kprogs, gkps = lowered
            lines += ["  " + (gkps[c.convs[0]].describe()
                              if c.convs[0] in gkps
                              else kprogs[c.convs[0]].describe())
                      for c in chains]
        elif self.mode == "wave":
            lines += ["  " + _partition_waves_cached(p).describe()
                      for p in self.programs]
        else:
            lines += ["  " + p.describe() for p in self.programs]
        return "\n".join(lines)
