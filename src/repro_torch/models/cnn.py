"""Conv nets on the streaming substrate: weights for a ``NetworkGraph``.

The counterpart of the graph half of ``repro/models/cnn.py``. Weights
are a dict ``{conv node name: (w, b)}`` with ``w`` in HWIO layout
``(K, K, in_c / groups, out_c)`` and ``b`` of shape ``(out_c,)``, fp32 —
the same layout as the reference, so one set of numbers serves both.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.graph import NetworkGraph
from repro_torch.core.streaming import run_graph_reference

Weights = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _weight_shape(layer) -> Tuple[int, int, int, int]:
    return (layer.kernel, layer.kernel, layer.in_c // layer.groups,
            layer.out_c)


def init_graph_weights(graph: NetworkGraph, generator: torch.Generator,
                       device, scale: float | None = None) -> Weights:
    """He-normal conv weights and zero biases for every conv node, drawn
    from ``generator`` on its own device and placed on ``device``.
    ``scale`` overrides the per-layer He factor."""
    weights = {}
    for n in graph.conv_nodes():
        l = n.layer
        fan_in = l.kernel * l.kernel * (l.in_c // l.groups)
        s = scale if scale is not None else (2.0 / fan_in) ** 0.5
        w = torch.randn(_weight_shape(l), generator=generator,
                        device=generator.device) * s
        weights[n.name] = (w.to(device), torch.zeros(l.out_c, device=device))
    return weights


def weights_from_numpy(graph: NetworkGraph,
                       np_weights: Mapping[str, tuple],
                       device) -> Weights:
    """Carry weights across from numpy: ``{node: (w, b)}`` with HWIO
    ``w`` and ``(out_c,)`` ``b`` (``None`` for no bias), as the JAX
    package's ``init_graph_weights`` makes them after ``np.asarray``.
    Every shape is checked against the graph's conv nodes; a missing or
    extra node raises."""
    convs = {n.name: n.layer for n in graph.conv_nodes()}
    missing = sorted(set(convs) - set(np_weights))
    extra = sorted(set(np_weights) - set(convs))
    if missing or extra:
        raise ValueError(f"{graph.name}: weights missing for {missing}, "
                         f"extra for {extra}")
    out = {}
    for name, l in convs.items():
        w, b = np_weights[name]
        w = np.asarray(w, np.float32)
        if w.shape != _weight_shape(l):
            raise ValueError(f"{graph.name}.{name}: weight {w.shape} != "
                             f"HWIO {_weight_shape(l)}")
        if b is not None:
            b = np.asarray(b, np.float32)
            if b.shape != (l.out_c,):
                raise ValueError(f"{graph.name}.{name}: bias {b.shape} != "
                                 f"({l.out_c},)")
            b = torch.tensor(b, device=device)
        out[name] = (torch.tensor(w, device=device), b)
    return out


def apply_graph(graph: NetworkGraph, weights,
                x: torch.Tensor) -> torch.Tensor:
    """Direct (undecomposed) reference forward: the graph's output value
    of ``run_graph_reference``."""
    return run_graph_reference(graph, weights, x)[graph.output]
