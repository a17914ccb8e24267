"""NetworkGraph IR — topology-aware program representation.

The paper claims the streaming architecture "is able to support most
popular CNNs" via image and feature decomposition; its companion
reconfigurable accelerator (Du et al., arXiv:1707.02973) makes that
concrete with a *layer-sequencing controller* that walks an arbitrary
layer topology over one set of SRAM banks. This module is the software
equivalent: the implicit ``Sequence[ConvLayer]`` contract the executors
used to thread around is promoted to an explicit graph IR —

  * **nodes** are ops: ``conv`` (a planned, streamed CONV(+POOL) layer,
    optionally with a fused ReLU) and ``add`` (the residual
    accumulation-buffer add, optionally with a fused ReLU). Projection
    shortcuts are ordinary 1x1 ``conv`` nodes — the schedule treats
    them exactly like any other streamed conv.
  * **edges** are values: every node produces one named activation
    value; edges carry the activation shape (H, W, C) and dtype
    (``value_shapes`` / ``value_dtypes``). The reserved value
    ``"input"`` is the network input.
  * a **validated topological schedule** (``topological_schedule``)
    replaces positional layer lists everywhere: executors walk nodes in
    schedule order, weights/operand tables key by *node name*, and
    calibration observes *graph values*, not list indices.

Two analyses run on the IR:

  * ``residual_fusion`` — which ``add`` nodes fold into the producing
    conv's megakernel epilogue (the paper's accumulation-SRAM add): an
    add fuses into its conv operand when that conv's output is consumed
    by the add alone, the conv has no ReLU of its own (the block's ReLU
    belongs to the add), and no pool sits between conv and add.
  * ``BufferPlan`` (``plan_buffers``) — graph-aware HBM activation
    liveness: a value's buffer is freed the moment its last consumer
    has fired, so e.g. a ResNet identity shortcut holds exactly one
    extra buffer across its block instead of every activation living
    until the end. ``peak_activation_bytes`` models peak activation
    HBM with and without the pass; the executors drop dead references
    per the plan so XLA can actually reuse the buffers.

Everything is frozen/hashable: a ``NetworkGraph`` (or its compact
``topology_key``) is a valid cache-key component, which is what keeps
two graphs that share a layer geometry from ever colliding in the
executor caches (core/streaming.py).
"""
from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.decomposition import ConvLayer

INPUT = "input"          # the reserved network-input value name


@dataclasses.dataclass(frozen=True)
class GraphNode:
    """One op of a NetworkGraph; produces the value named ``name``.

    ``op="conv"``: ``layer`` holds the planned ConvLayer (its fused
    max-pool included); ``relu`` applies max(x, 0) after bias (and
    before the pool, matching the streamed executors). ``op="add"``:
    elementwise sum of exactly two same-shape, same-dtype operands —
    the paper's accumulation-buffer add; ``relu`` applies after the
    sum (the usual post-block ReLU).
    """
    name: str
    op: str                          # "conv" | "add"
    inputs: Tuple[str, ...]
    layer: Optional[ConvLayer] = None
    relu: bool = True
    dtype: Optional[str] = None      # output dtype override (None = graph's)


@dataclasses.dataclass(frozen=True)
class NetworkGraph:
    """A validated CNN program: nodes wired by named activation values.

    ``in_shape`` is the (H, W, C) of the reserved ``"input"`` value;
    ``output`` names the value the network returns. ``nodes`` may be
    listed in any order — validation derives (and requires the
    existence of) a topological schedule.
    """
    name: str
    in_shape: Tuple[int, int, int]
    nodes: Tuple[GraphNode, ...]
    output: str
    dtype: str = "float32"

    def __post_init__(self):
        validate_graph(self)

    @property
    def topology_key(self) -> tuple:
        """Hashable identity of the *wiring* and per-node geometry —
        the cache-key component that keeps two graphs sharing a layer
        geometry from colliding in the executor caches."""
        return (self.name, self.in_shape, self.dtype, self.output,
                tuple((n.name, n.op, n.inputs, n.layer, n.relu, n.dtype)
                      for n in self.nodes))

    def node(self, name: str) -> GraphNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(f"{self.name}: no node named {name!r}")

    def conv_nodes(self) -> Tuple[GraphNode, ...]:
        """Conv nodes in schedule order — the canonical weight order."""
        return tuple(n for n in topological_schedule(self)
                     if n.op == "conv")

    def describe(self) -> str:
        shapes = value_shapes(self)
        lines = [f"NetworkGraph {self.name}: {len(self.nodes)} nodes "
                 f"({len(self.conv_nodes())} conv), input "
                 f"{self.in_shape}, output {self.output} "
                 f"{shapes[self.output]}"]
        for n in topological_schedule(self):
            src = ", ".join(n.inputs)
            lines.append(f"  {n.name} = {n.op}({src})"
                         f"{' +relu' if n.relu else ''} "
                         f"-> {shapes[n.name]}")
        return "\n".join(lines)


class GraphValidationError(ValueError):
    """A NetworkGraph that no executor could schedule or run."""


def _producers(g: NetworkGraph) -> Dict[str, GraphNode]:
    by_name: Dict[str, GraphNode] = {}
    for n in g.nodes:
        if n.name == INPUT:
            raise GraphValidationError(
                f"{g.name}: node name {INPUT!r} is reserved for the "
                f"network input")
        if n.name in by_name:
            raise GraphValidationError(
                f"{g.name}: duplicate node name {n.name!r}")
        by_name[n.name] = n
    return by_name


@functools.lru_cache(maxsize=256)
def topological_schedule(g: NetworkGraph) -> Tuple[GraphNode, ...]:
    """Kahn's algorithm over value dependencies; deterministic (listed
    node order breaks ties). Raises if no topological order exists."""
    by_name = _producers(g)
    indeg = {n.name: sum(1 for v in n.inputs if v != INPUT)
             for n in g.nodes}
    consumers: Dict[str, List[str]] = {}
    for n in g.nodes:
        for v in n.inputs:
            if v != INPUT:
                consumers.setdefault(v, []).append(n.name)
    ready = [n for n in g.nodes if indeg[n.name] == 0]
    order: List[GraphNode] = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for c in consumers.get(n.name, ()):
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(by_name[c])
    if len(order) != len(g.nodes):
        stuck = sorted(name for name, d in indeg.items() if d > 0)
        raise GraphValidationError(
            f"{g.name}: no topological schedule — cycle through {stuck}")
    return tuple(order)


@functools.lru_cache(maxsize=256)
def value_shapes(g: NetworkGraph) -> Dict[str, Tuple[int, int, int]]:
    """(H, W, C) of every value, ``"input"`` included."""
    shapes: Dict[str, Tuple[int, int, int]] = {INPUT: g.in_shape}
    for n in topological_schedule(g):
        if n.op == "conv":
            l = n.layer
            shapes[n.name] = (l.pooled_h, l.pooled_w, l.out_c)
        else:
            shapes[n.name] = shapes[n.inputs[0]]
    return shapes


@functools.lru_cache(maxsize=256)
def value_dtypes(g: NetworkGraph) -> Dict[str, str]:
    """dtype of every value (node overrides flow forward)."""
    dts: Dict[str, str] = {INPUT: g.dtype}
    for n in topological_schedule(g):
        dts[n.name] = n.dtype or dts[n.inputs[0]]
    return dts


@functools.lru_cache(maxsize=256)
def value_consumers(g: NetworkGraph) -> Dict[str, Tuple[str, ...]]:
    cons: Dict[str, List[str]] = {INPUT: []}
    for n in g.nodes:
        cons.setdefault(n.name, [])
        for v in n.inputs:
            cons.setdefault(v, []).append(n.name)
    return {v: tuple(c) for v, c in cons.items()}


def validate_graph(g: NetworkGraph) -> None:
    """Everything an executor assumes, checked up front:

    1. node names unique, ``"input"`` reserved, all input references
       resolve, and a topological schedule exists (no cycles);
    2. conv nodes: exactly one input whose (H, W, C) matches the
       layer's declared input — a stale edge would make the schedule
       offsets silently address the wrong pixels;
    3. add nodes: exactly two operands with identical shapes AND
       dtypes (the accumulation-buffer add has no broadcasting and no
       implicit casts);
    4. every edge consumed: each value except the graph output feeds
       at least one node (a dangling value is almost always a
       mis-wired residual), and the output value exists.
    """
    by_name = _producers(g)
    known = {INPUT} | set(by_name)
    for n in g.nodes:
        for v in n.inputs:
            if v not in known:
                raise GraphValidationError(
                    f"{g.name}: node {n.name!r} reads undefined value "
                    f"{v!r}")
        if n.op == "conv":
            if n.layer is None:
                raise GraphValidationError(
                    f"{g.name}: conv node {n.name!r} has no layer")
            if len(n.inputs) != 1:
                raise GraphValidationError(
                    f"{g.name}: conv node {n.name!r} wants exactly one "
                    f"input, got {len(n.inputs)}")
        elif n.op == "add":
            if len(n.inputs) != 2:
                raise GraphValidationError(
                    f"{g.name}: add node {n.name!r} wants exactly two "
                    f"operands, got {len(n.inputs)}")
        else:
            raise GraphValidationError(
                f"{g.name}: unknown op {n.op!r} on node {n.name!r}")
    if g.output not in known or g.output == INPUT:
        raise GraphValidationError(
            f"{g.name}: output value {g.output!r} is not produced by "
            f"any node")
    # schedule existence + shape/dtype agreement (computed post-schedule)
    shapes = value_shapes(g)
    dtypes = value_dtypes(g)
    for n in topological_schedule(g):
        if n.op == "conv":
            l = n.layer
            got = shapes[n.inputs[0]]
            if got != (l.in_h, l.in_w, l.in_c):
                raise GraphValidationError(
                    f"{g.name}: conv node {n.name!r} reads "
                    f"{n.inputs[0]!r} of shape {got}, layer declares "
                    f"({l.in_h}, {l.in_w}, {l.in_c})")
        else:
            a, b = n.inputs
            if shapes[a] != shapes[b]:
                raise GraphValidationError(
                    f"{g.name}: add node {n.name!r} operands disagree: "
                    f"{a!r} {shapes[a]} vs {b!r} {shapes[b]}")
            if dtypes[a] != dtypes[b]:
                raise GraphValidationError(
                    f"{g.name}: add node {n.name!r} operand dtypes "
                    f"disagree: {a!r} {dtypes[a]} vs {b!r} {dtypes[b]}")
    for v, cons in value_consumers(g).items():
        if not cons and v != g.output:
            raise GraphValidationError(
                f"{g.name}: value {v!r} is never consumed "
                f"(dangling edge — mis-wired residual?)")


# ---------------------------------------------------------------------------
# Residual-fusion analysis: which adds fold into a conv's megakernel
# epilogue (the paper's accumulation-SRAM add)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResidualFusion:
    """``fused[add_name] = (conv_name, residual_value)``: the add runs
    inside ``conv_name``'s kernel epilogue, reading ``residual_value``
    as the extra operand; the add's ReLU becomes the epilogue ReLU and
    the add's value is produced by the conv's launch. Adds not in
    ``fused`` execute as explicit elementwise ops."""
    fused: Tuple[Tuple[str, Tuple[str, str]], ...]

    def as_dict(self) -> Dict[str, Tuple[str, str]]:
        return dict(self.fused)

    def conv_residual(self) -> Dict[str, str]:
        """conv node name -> residual value its epilogue adds."""
        return {conv: res for _, (conv, res) in self.fused}

    def add_of_conv(self) -> Dict[str, str]:
        """conv node name -> the add node it produces the value for."""
        return {conv: add for add, (conv, _) in self.fused}


@functools.lru_cache(maxsize=256)
def residual_fusion(g: NetworkGraph) -> ResidualFusion:
    """An ``add`` fuses into a conv operand's epilogue when:

    * the operand is a conv node whose output is consumed by this add
      ONLY (otherwise the pre-add activation must exist in HBM anyway);
    * that conv has no ReLU of its own (the block ReLU belongs after
      the add) and no fused pool (pooling a pre-add activation would
      change shapes before the accumulation-buffer add);
    * the OTHER operand is already produced when the conv fires (the
      epilogue DMAs it as a kernel operand — a shortcut whose own chain
      schedules later cannot fold in);
    * when both operands qualify, the one scheduled later wins (its
      epilogue is the last writer, so the other operand is available).
    """
    sched = topological_schedule(g)
    pos = {n.name: i for i, n in enumerate(sched)}
    pos[INPUT] = -1
    cons = value_consumers(g)
    by_name = {n.name: n for n in g.nodes}
    fused: List[Tuple[str, Tuple[str, str]]] = []
    for n in sched:
        if n.op != "add":
            continue
        cands = []
        for v in n.inputs:
            p = by_name.get(v)
            if (p is not None and p.op == "conv" and not p.relu
                    and p.layer.pool <= 1 and cons[v] == (n.name,)):
                cands.append(v)
        for conv in sorted(set(cands), key=lambda v: -pos[v]):
            other = n.inputs[0] if n.inputs[1] == conv else n.inputs[1]
            if other == conv:        # add(x, x): keep it explicit
                continue
            if pos[other] < pos[conv]:   # shortcut available in time
                fused.append((n.name, (conv, other)))
                break
    return ResidualFusion(fused=tuple(fused))


# ---------------------------------------------------------------------------
# Buffer liveness: free each activation once its last consumer fired
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BufferPlan:
    """Per-schedule-step activation-buffer lifetime plan.

    ``frees[i]`` lists the values whose last consumer is schedule step
    ``i`` — the executor drops those references right after step ``i``
    runs, donating the HBM buffer back to XLA. The graph output (and
    any value with no consumers-after) is never freed.
    """
    schedule: Tuple[str, ...]            # node names, schedule order
    frees: Tuple[Tuple[str, ...], ...]   # values freeable after step i

    def validate(self, g: NetworkGraph) -> None:
        """No value is freed before (or at) a step that still reads or
        produces it, and nothing is freed twice — the property the
        hypothesis suite hammers."""
        sched = topological_schedule(g)
        assert self.schedule == tuple(n.name for n in sched)
        freed: Dict[str, int] = {}
        for i, fs in enumerate(self.frees):
            for v in fs:
                if v in freed:
                    raise AssertionError(
                        f"{g.name}: {v!r} freed twice (steps "
                        f"{freed[v]} and {i})")
                freed[v] = i
        for i, n in enumerate(sched):
            for v in n.inputs:
                if v in freed and freed[v] < i:
                    raise AssertionError(
                        f"{g.name}: step {i} ({n.name}) reads {v!r} "
                        f"freed after step {freed[v]}")
            if n.name in freed and freed[n.name] < i:
                raise AssertionError(
                    f"{g.name}: {n.name!r} freed before it is produced")
        if g.output in freed:
            raise AssertionError(f"{g.name}: output {g.output!r} freed")


@functools.lru_cache(maxsize=256)
def plan_buffers(g: NetworkGraph) -> BufferPlan:
    sched = topological_schedule(g)
    last_use: Dict[str, int] = {}
    for i, n in enumerate(sched):
        for v in n.inputs:
            last_use[v] = i
    frees: List[Tuple[str, ...]] = []
    for i, n in enumerate(sched):
        fs = [v for v, j in last_use.items() if j == i and v != g.output]
        frees.append(tuple(fs))
    plan = BufferPlan(schedule=tuple(n.name for n in sched),
                      frees=tuple(frees))
    plan.validate(g)
    return plan


def peak_activation_bytes(g: NetworkGraph, batch: int = 1,
                          bytes_per_elem: int = 4,
                          liveness: bool = True) -> int:
    """Modelled peak activation HBM across one forward pass.

    ``liveness=False`` is the naive per-edge allocation every list-based
    executor implied: one buffer per value, all live until the end.
    ``liveness=True`` walks the schedule with the BufferPlan: a node's
    output is allocated while its inputs are still live (no in-place
    aliasing is assumed), then every value past its last consumer is
    freed — the number the ResNet-18 acceptance gate compares.
    """
    shapes = value_shapes(g)
    size = {v: batch * h * w * c * bytes_per_elem
            for v, (h, w, c) in shapes.items()}
    if not liveness:
        return sum(size.values())
    plan = plan_buffers(g)
    sched = topological_schedule(g)
    live = size[INPUT]
    peak = live
    for i, n in enumerate(sched):
        live += size[n.name]
        peak = max(peak, live)
        live -= sum(size[v] for v in plan.frees[i])
    return peak


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def conv_keyed(graph: NetworkGraph, items, what: str) -> "OrderedDict":
    """Normalise per-conv-node data: a mapping keyed by node name, or a
    sequence zipped against the schedule-ordered conv nodes — the one
    calling convention every graph executor, session, and calibrator
    shares for plans/weights/programs."""
    convs = graph.conv_nodes()
    if isinstance(items, dict):
        missing = [n.name for n in convs if n.name not in items]
        if missing:
            raise ValueError(f"{graph.name}: {what} missing for conv "
                             f"nodes {missing}")
        return OrderedDict((n.name, items[n.name]) for n in convs)
    items = list(items)
    if len(items) != len(convs):
        raise ValueError(
            f"{graph.name}: {len(items)} {what} for {len(convs)} conv "
            f"nodes — pass a dict keyed by node name or one entry per "
            f"conv node in schedule order")
    return OrderedDict((n.name, it) for n, it in zip(convs, items))


def check_graph_input(graph: NetworkGraph, x) -> None:
    """Reject a batch whose (H, W, C) disagrees with the graph's input
    edge — schedule offsets would silently address the wrong pixels."""
    if tuple(x.shape[1:]) != tuple(graph.in_shape):
        raise GraphValidationError(
            f"{graph.name}: input batch {tuple(x.shape)} != declared "
            f"(B, {graph.in_shape[0]}, {graph.in_shape[1]}, "
            f"{graph.in_shape[2]}) — schedule offsets would silently "
            f"address the wrong pixels")


def chain_graph(layers: Sequence[ConvLayer], name: str = "chain",
                relu: bool = True, dtype: str = "float32") -> NetworkGraph:
    """The old implicit contract, made explicit: a linear conv stack
    (each layer reads the previous one's output) as a NetworkGraph."""
    layers = tuple(layers)
    if not layers:
        raise GraphValidationError(f"{name}: empty layer chain")
    nodes = []
    prev = INPUT
    for l in layers:
        nodes.append(GraphNode(name=l.name, op="conv", inputs=(prev,),
                               layer=l, relu=relu))
        prev = l.name
    return NetworkGraph(name=name,
                        in_shape=(layers[0].in_h, layers[0].in_w,
                                  layers[0].in_c),
                        nodes=tuple(nodes), output=prev, dtype=dtype)
