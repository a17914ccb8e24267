"""Post-training calibration: a float CNN -> a ``QuantizedGraph``.

The counterpart of ``repro/quant/calibrate.py``. Run a handful of
batches through the float reference walk, observe per-value activation
ranges and per-output-channel weight ranges, and freeze what the int8
datapath needs (int8 weights, int32 biases, fixed-point requantize
multipliers) into host numpy arrays.

Scales are symmetric with zero-point 0, so padding zeros stay exact
integer zeros: weights per output channel (absmax), activations per
tensor (absmax or a percentile of |x|). Layer i's output scale IS the
next layer's input scale, and both operands of every residual add share
the add's scale, so raw int8 activations flow along every edge.

``quantized_graph_from_numpy`` carries a calibration made elsewhere (the
JAX reference's ``QuantizedGraph``) across as numpy, validated like one
calibrated here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.decomposition import ConvLayer
from repro_torch.core.graph import (INPUT, NetworkGraph, chain_graph,
                                    conv_keyed, topological_schedule)
from repro_torch.core.quantization import INT8_QMAX, requant_params
from repro_torch.core.streaming import (conv2d_direct, maxpool_direct,
                                        run_graph_reference)
from repro_torch.kernels.wave_replay_q.kernel import exact_channel_chunk

# bias magnitudes are clipped here when a pathological scale pair would
# blow them up; the requantized output saturates at +-127 long before
_BIAS_CLIP = 1 << 30

# LayerQuant's fields as they cross over from numpy: array dtypes, then
# the scalars.
_ARRAY_FIELDS = {"wq": np.int8, "w_scale": np.float32, "bias_q": np.int32,
                 "m": np.int32, "shift": np.int32}
_SCALAR_FIELDS = {"in_scale": float, "out_scale": float, "pre_shift": int,
                  "acc_bound": int, "fan_chunk": int}


@dataclasses.dataclass(frozen=True)
class LayerQuant:
    """Everything the int8 datapath needs for ONE conv layer (host numpy).

    ``wq`` keeps the natural per-group weight layout (K, K, in_c/groups,
    out_c). ``m``/``shift``/``pre_shift`` encode the requantize
    multiplier ``in_scale * w_scale[c] / out_scale ~= m * 2^-shift``;
    ``acc_bound`` bounds |accumulator + bias|; ``fan_chunk`` is the
    reference kernel's weight-aware exact-fp32 gemm width.
    """
    wq: np.ndarray            # (K, K, in_c/groups, out_c) int8
    w_scale: np.ndarray       # (out_c,) float32
    in_scale: float
    out_scale: float
    bias_q: np.ndarray        # (out_c,) int32
    m: np.ndarray             # (out_c,) int32, 7-bit requant mantissa
    shift: np.ndarray         # (out_c,) int32
    pre_shift: int
    acc_bound: int
    fan_chunk: int

    def device_arrays(self, device="cuda") -> Tuple[torch.Tensor, ...]:
        """(wq int8, bias_q, m, shift int32) as tensors on ``device``."""
        return tuple(torch.as_tensor(a).to(device) for a in
                     (self.wq, self.bias_q, self.m, self.shift))


@dataclasses.dataclass(frozen=True)
class QuantizedNetwork:
    """A calibrated conv stack: layers + per-layer ``LayerQuant``, scales
    chained (``quants[i].out_scale == quants[i+1].in_scale``)."""
    layers: Tuple[ConvLayer, ...]
    quants: Tuple[LayerQuant, ...]
    method: str = "percentile"

    def __post_init__(self):
        if len(self.layers) != len(self.quants):
            raise ValueError("layers and quants must pair up")
        for i, (a, b) in enumerate(zip(self.quants[:-1], self.quants[1:])):
            if a.out_scale != b.in_scale:
                raise ValueError(
                    f"layer {i}->{i + 1}: out_scale {a.out_scale} != next "
                    f"in_scale {b.in_scale}: int8 activations could not "
                    f"flow between layers unconverted")

    @property
    def in_scale(self) -> float:
        return self.quants[0].in_scale

    @property
    def out_scale(self) -> float:
        return self.quants[-1].out_scale


@dataclasses.dataclass(frozen=True)
class QuantizedGraph:
    """A calibrated NetworkGraph: per-conv-node ``LayerQuant`` (keyed by
    node name) + per-VALUE activation scales (``"input"`` included).

    Validated: every conv's in/out scale equals its input/output value's
    scale, and both operands of every ``add`` share the add's scale.
    """
    graph: NetworkGraph
    quants: "dict[str, LayerQuant]"
    scales: "dict[str, float]"
    method: str = "percentile"

    def __post_init__(self):
        conv_names = {n.name for n in self.graph.conv_nodes()}
        if set(self.quants) != conv_names:
            raise ValueError(
                f"{self.graph.name}: quants keyed {sorted(self.quants)} "
                f"!= conv nodes {sorted(conv_names)}")
        for n in topological_schedule(self.graph):
            if n.op == "conv":
                q = self.quants[n.name]
                if q.in_scale != self.scales[n.inputs[0]] \
                        or q.out_scale != self.scales[n.name]:
                    raise ValueError(
                        f"{self.graph.name}: {n.name} scales "
                        f"({q.in_scale}, {q.out_scale}) disagree with "
                        f"edge scales: int8 activations could not flow "
                        f"unconverted")
            else:
                a, b = n.inputs
                if not (self.scales[a] == self.scales[b]
                        == self.scales[n.name]):
                    raise ValueError(
                        f"{self.graph.name}: add {n.name} operands/"
                        f"output must share one scale "
                        f"({self.scales[a]}, {self.scales[b]}, "
                        f"{self.scales[n.name]})")

    def device_weights(self, device="cuda"
                       ) -> "dict[str, Tuple[torch.Tensor, ...]]":
        """Per-conv-node (wq, bias_q, m, shift) on ``device``, the int8
        graph forward's weights."""
        return {name: q.device_arrays(device)
                for name, q in self.quants.items()}


# ---------------------------------------------------------------------------
# Observers
# ---------------------------------------------------------------------------

def activation_scale(values, method: str = "percentile",
                     percentile: float = 99.9) -> float:
    """Per-tensor symmetric scale from observed activation values.

    ``absmax`` uses the largest |x| seen; ``percentile`` clips to the
    given percentile of |x|. All-zero observations fall back to 1.0."""
    if torch.is_tensor(values):
        values = values.detach().cpu().numpy()
    a = np.abs(np.asarray(values, np.float32).ravel())
    if method == "absmax":
        amax = float(a.max()) if a.size else 0.0
    elif method == "percentile":
        amax = float(np.percentile(a, percentile)) if a.size else 0.0
    else:
        raise ValueError(f"unknown calibration method {method!r} "
                         f"(expected absmax | percentile)")
    if amax <= 0.0:
        return 1.0
    return amax / INT8_QMAX


def quantize_weights_per_channel(w) -> Tuple[np.ndarray, np.ndarray]:
    """(K, K, fan, out_c) float -> per-output-channel symmetric int8.

    All-zero channels get scale 1.0."""
    if torch.is_tensor(w):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=(0, 1, 2))
    w_scale = np.where(amax > 0.0, amax / INT8_QMAX, 1.0).astype(np.float32)
    wq = np.clip(np.rint(w / w_scale), -INT8_QMAX, INT8_QMAX)
    return wq.astype(np.int8), w_scale


def quantize_layer(layer: ConvLayer, w, b,
                   in_scale: float, out_scale: float) -> LayerQuant:
    """Freeze one layer's integer datapath from float weights + scales."""
    wq, w_scale = quantize_weights_per_channel(w)
    if wq.shape != (layer.kernel, layer.kernel,
                    layer.in_c // layer.groups, layer.out_c):
        raise ValueError(
            f"{layer.name}: weights {wq.shape} != declared "
            f"({layer.kernel}, {layer.kernel}, "
            f"{layer.in_c // layer.groups}, {layer.out_c})")
    if torch.is_tensor(b):
        b = b.detach().cpu().numpy()
    acc_scale = in_scale * w_scale.astype(np.float64)
    bias = np.zeros((layer.out_c,), np.float64) if b is None \
        else np.asarray(b, np.float64)
    bias_q = np.clip(np.rint(bias / acc_scale),
                     -_BIAS_CLIP, _BIAS_CLIP).astype(np.int32)
    fan = layer.kernel * layer.kernel * (layer.in_c // layer.groups)
    acc_bound = fan * INT8_QMAX * INT8_QMAX + int(np.abs(bias_q).max())
    m, shift, pre_shift = requant_params(acc_scale / out_scale, acc_bound)
    # weight-aware exact-fp32 gemm bound: every partial sum of an int8
    # activation x wq gemm is <= 127 * (worst column's sum |wq|)
    col_sums = np.abs(wq.astype(np.int64)).sum(axis=(0, 1, 2))
    if int(col_sums.max()) * INT8_QMAX < 1 << 24:
        fan_chunk = layer.in_c // layer.groups      # unchunked
    else:
        fan_chunk = exact_channel_chunk(layer.kernel)
    return LayerQuant(wq=wq, w_scale=w_scale, in_scale=float(in_scale),
                      out_scale=float(out_scale), bias_q=bias_q, m=m,
                      shift=shift, pre_shift=pre_shift,
                      acc_bound=acc_bound, fan_chunk=fan_chunk)


# ---------------------------------------------------------------------------
# Calibration: observe the float network, freeze the integer one
# ---------------------------------------------------------------------------

def float_network_acts(layers: Sequence[ConvLayer], weights,
                       x: torch.Tensor) -> List[torch.Tensor]:
    """Reference float forward of a linear stack returning every layer
    boundary ``[x, act_1, ..., act_N]`` (post-ReLU, post-pool): the
    tensors the int8 path carries as int8."""
    acts = [x]
    y = x
    for l, (w, b) in zip(layers, weights):
        y = conv2d_direct(y, w.to(x.dtype), l.stride, l.pad,
                          groups=l.groups)
        if b is not None:
            y = y + b.to(x.dtype)
        y = torch.relu(y)
        if l.pool > 1:
            y = maxpool_direct(y, l.pool, l.pool_stride or l.pool)
        acts.append(y)
    return acts


def float_graph_acts(graph: NetworkGraph, weights,
                     x: torch.Tensor) -> "dict[str, torch.Tensor]":
    """Reference float forward over the graph schedule returning every
    VALUE (``"input"`` included), through the one shared walk
    ``run_graph_reference``."""
    return run_graph_reference(graph, weights, x)


def _unify_add_scales(graph: NetworkGraph,
                      base: "dict[str, float]") -> "dict[str, float]":
    """Union-find over values: each add node's operands and output land
    in one scale group, whose scale is the max of its members'."""
    parent = {v: v for v in base}

    def find(v):
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for n in graph.nodes:
        if n.op == "add":
            union(n.inputs[0], n.name)
            union(n.inputs[1], n.name)
    groups: "dict[str, float]" = {}
    for v in base:
        r = find(v)
        groups[r] = max(groups.get(r, 0.0), base[v])
    return {v: groups[find(v)] for v in base}


def calibrate_graph(graph: NetworkGraph, weights, calib,
                    method: str = "percentile",
                    percentile: float = 99.9) -> QuantizedGraph:
    """PTQ calibration over a NetworkGraph: run ``calib`` (one (N, H, W,
    C) tensor or an iterable of them) through the float graph walk on
    the tensors' device, observe every VALUE, unify add-operand scales,
    and freeze each conv node with its input value's scale in and its
    own value's scale out."""
    weights = conv_keyed(graph, weights, "weights")
    if torch.is_tensor(calib):
        calib = [calib]
    samples: "dict[str, List[np.ndarray]]" = {}
    n_batches = 0
    with torch.no_grad():
        for batch in calib:
            n_batches += 1
            for v, act in float_graph_acts(graph, weights,
                                           batch.float()).items():
                samples.setdefault(v, []).append(
                    act.detach().cpu().numpy().astype(np.float32).ravel())
    if n_batches == 0:
        raise ValueError("calibration needs at least one batch")
    base = {v: activation_scale(np.concatenate(s), method, percentile)
            for v, s in samples.items()}
    scales = _unify_add_scales(graph, base)
    quants = {
        n.name: quantize_layer(n.layer, *weights[n.name],
                               scales[n.inputs[0]], scales[n.name])
        for n in graph.conv_nodes()}
    return QuantizedGraph(graph=graph, quants=quants, scales=scales,
                          method=method)


def quantized_graph_from_network(qnet: QuantizedNetwork,
                                 graph: NetworkGraph) -> QuantizedGraph:
    """Adapt a linear-stack ``QuantizedNetwork`` to its chain graph's
    ``QuantizedGraph`` (same quants, scales keyed by value name)."""
    convs = graph.conv_nodes()
    if tuple(n.layer for n in convs) != tuple(qnet.layers) \
            or any(n.op != "conv" for n in graph.nodes):
        raise ValueError(
            f"{graph.name}: not the chain graph of this QuantizedNetwork")
    quants = {n.name: q for n, q in zip(convs, qnet.quants)}
    scales = {INPUT: qnet.in_scale}
    for n, q in zip(convs, qnet.quants):
        scales[n.name] = q.out_scale
    return QuantizedGraph(graph=graph, quants=quants, scales=scales,
                          method=qnet.method)


def calibrate_network(layers: Sequence[ConvLayer], weights, calib,
                      method: str = "percentile",
                      percentile: float = 99.9) -> QuantizedNetwork:
    """PTQ calibration of a linear stack: ``calibrate_graph`` over the
    stack's chain graph, repackaged as a ``QuantizedNetwork``."""
    layers = tuple(layers)
    qg = calibrate_graph(chain_graph(layers), list(weights), calib, method,
                         percentile)
    return QuantizedNetwork(layers=layers,
                            quants=tuple(qg.quants[l.name] for l in layers),
                            method=method)


def quantized_graph_from_numpy(graph: NetworkGraph,
                               quants: Mapping[str, object],
                               scales: Mapping[str, float],
                               method: str = "percentile"
                               ) -> QuantizedGraph:
    """Build a ``QuantizedGraph`` from numpy fields calibrated elsewhere.

    ``quants`` maps conv node name to the fields of a ``LayerQuant``
    (``wq, w_scale, in_scale, out_scale, bias_q, m, shift, pre_shift,
    acc_bound, fan_chunk``), as a mapping or as attributes of any object
    (the reference's ``LayerQuant`` is one); ``scales`` maps every value
    to its activation scale. Dtypes and shapes are checked against each
    node's layer, then the graph's scale invariants as for a graph
    calibrated here."""
    layers = {n.name: n.layer for n in graph.conv_nodes()}
    if set(quants) != set(layers):
        raise ValueError(f"{graph.name}: quants keyed {sorted(quants)} != "
                         f"conv nodes {sorted(layers)}")
    out = {}
    for name, src in quants.items():
        def field(f):
            return src[f] if isinstance(src, Mapping) else getattr(src, f)
        l = layers[name]
        kw = {}
        for f, dt in _ARRAY_FIELDS.items():
            a = np.asarray(field(f))
            want = (l.kernel, l.kernel, l.in_c // l.groups, l.out_c) \
                if f == "wq" else (l.out_c,)
            if a.dtype != dt or a.shape != want:
                raise ValueError(f"{graph.name}.{name}: {f} is {a.dtype} "
                                 f"{a.shape}, want {np.dtype(dt)} {want}")
            kw[f] = a.copy()
        for f, cast in _SCALAR_FIELDS.items():
            kw[f] = cast(field(f))
        out[name] = LayerQuant(**kw)
    vals = {INPUT} | {n.name for n in graph.nodes}
    if set(scales) != vals:
        raise ValueError(f"{graph.name}: scales keyed {sorted(scales)} != "
                         f"values {sorted(vals)}")
    return QuantizedGraph(graph=graph, quants=out,
                          scales={v: float(s) for v, s in scales.items()},
                          method=method)
