"""Streaming sessions: batched multi-image CNN serving on the card.

The counterpart of ``repro/launch/session.py`` for ``mode="megakernel"``
at fp32. The session takes a ``NetworkGraph`` (or a plain layer
sequence, wrapped into its chain graph), plans and lowers every conv
node once at construction, and serves each request batch with ONE
wave-replay kernel launch per conv node. Per batch shape it builds the
forward and uploads the operand tables to the device once
(``compile_count``), then replays them for every call.

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
from repro_torch.core.graph import NetworkGraph, chain_graph, conv_keyed
from repro_torch.core.schedule import TileProgram
from repro_torch.core.streaming import (check_mode, compile_graph,
                                        graph_forward_fn, graph_operands,
                                        plan_graph)
from repro_torch.kernels.wave_replay.ops import launch_count, plain_count
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


class StreamingSession:
    """One (graph, plan-set) serving session, one forward per batch shape.

    ``mode`` must be ``"megakernel"`` and ``precision`` ``"fp32"``; the
    reference's other modes, ``mode="auto"``, ``precision="int8"``,
    ``fallback``, ``guard`` and ``tracer`` raise ``NotImplementedError``
    naming the ROADMAP item that ports them. Kernel programs are lowered
    at ``max_batch`` as the reference lowers them, so the operand tables
    are the reference's. ``max_pending`` bounds the queue (``submit``
    raises ``Overloaded`` when full); ``submit(..., deadline=s)`` drops a
    request still queued ``s`` seconds later.
    """

    def __init__(self, graph, plans, weights, max_batch: int = 8,
                 mode: str = "megakernel", precision: str = "fp32",
                 device=None, max_pending: Optional[int] = None,
                 validate_inputs: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 fallback=None, guard=None, tracer=None):
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
        check_mode(mode, precision)
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
        self.weights = {
            name: (w.to(self.device, torch.float32).contiguous(),
                   None if b is None
                   else b.to(self.device, torch.float32).contiguous())
            for name, (w, b) in conv_keyed(graph, weights,
                                           "weights").items()}
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
                                   batch=self.max_batch)
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
        if not t.dtype.is_floating_point:
            raise ValueError(
                f"{self.graph.name}.{what}: expected {spec} "
                f"{self.graph.dtype} input, got dtype {t.dtype}")
        if not bool(torch.isfinite(t).all()):
            raise ValueError(
                f"{self.graph.name}.{what}: input contains NaN/Inf — "
                f"refusing to serve (expected finite {spec} "
                f"{self.graph.dtype})")

    def run_batch(self, x) -> torch.Tensor:
        """(B, H, W, C) -> network output on the session's device."""
        if self.validate_inputs:
            self.check_input(x, batched=True)
        x = torch.as_tensor(x).to(self.device, torch.float32)
        fwd, ops = self._executable(self._exec_key(x.shape, x.dtype))
        self.calls += 1
        return fwd(x, self.weights, ops)

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
        imgs = torch.stack([im.to(self.device, torch.float32)
                            for _, im in live])
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

    def health(self) -> dict:
        """Machine-readable serving health: mode, device, the executor of
        each conv node (one kernel launch each per forward), and the
        session's counters."""
        return {
            "graph": self.graph.name,
            "mode": self.mode,
            "precision": self.precision,
            "device": str(self.device),
            "node_modes": {name: self.mode for name in self._progs},
            "launches_per_forward": len(self.programs),
            "counters": {
                "shed": self.shed,
                "deadline_expired": self.deadline_expired,
                "compiles": self.compile_count,
                "calls": self.calls,
                "kernel_launches": launch_count(),
                "plain_calls": plain_count(),
            },
            "pending": len(self._pending),
            "executables": len(self._executables),
        }

    def describe(self) -> str:
        lines = [f"StreamingSession[{self.graph.name}]: "
                 f"{len(self.graph.nodes)} nodes "
                 f"({len(self.programs)} conv), "
                 f"mode={self.mode}, precision={self.precision}, "
                 f"device={self.device}, max_batch={self.max_batch}, "
                 f"executables={len(self._executables)}, "
                 f"compiles={self.compile_count}, calls={self.calls}"]
        lines += ["  " + p.describe() for p in self.programs]
        return "\n".join(lines)
