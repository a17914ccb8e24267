"""Accuracy of the int8 path: SNR against fp32, and the int32 reference.

``quant_reference_acts`` / ``quant_graph_reference_acts`` walk a
calibrated network on the int32 oracle (``wave_replay_q/ref.py``), the
model the int8 kernels must match bit for bit. ``snr_db`` measures how
far the dequantized int8 activations drift from the float network.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from repro_torch.core.graph import INPUT, topological_schedule
from repro_torch.core.quantization import quantize_int8_sym
from repro_torch.kernels.wave_replay_q.ref import (
    quant_layer_ref_from_quant, residual_add_i8)


def snr_db(ref, got) -> float:
    """Signal-to-noise of ``got`` against ``ref`` in dB (inf if equal)."""
    def host(a):
        if torch.is_tensor(a):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float64)

    ref = host(ref)
    err = host(got) - ref
    noise = float((err ** 2).sum())
    if noise == 0.0:
        return math.inf
    power = float((ref ** 2).sum())
    if power == 0.0:
        return -math.inf
    return 10.0 * math.log10(power / noise)


def quant_reference_acts(qnet, x: torch.Tensor) -> List[torch.Tensor]:
    """The int32-reference model of a linear stack, layer by layer: each
    layer's int8 activation (post-ReLU, post-pool)."""
    xq = quantize_int8_sym(x, qnet.in_scale)
    acts = []
    for l, lq in zip(qnet.layers, qnet.quants):
        xq = quant_layer_ref_from_quant(l, xq, lq, relu=True,
                                        fuse_pool=l.pool > 1)
        acts.append(xq)
    return acts


def quant_graph_reference_acts(qgraph, x: torch.Tensor) -> dict:
    """The int32-reference model over a NetworkGraph schedule: every
    VALUE's int8 activation, keyed by value name. Conv nodes run the
    oracle with the node's ReLU; add nodes run ``residual_add_i8``, which
    is what a fused epilogue computes too. An int8 ``x`` is taken as the
    input's codes; a float one is quantized at the input's scale."""
    env = {INPUT: x if x.dtype == torch.int8
           else quantize_int8_sym(x, qgraph.scales[INPUT])}
    for n in topological_schedule(qgraph.graph):
        if n.op == "conv":
            env[n.name] = quant_layer_ref_from_quant(
                n.layer, env[n.inputs[0]], qgraph.quants[n.name],
                relu=n.relu, fuse_pool=n.layer.pool > 1)
        else:
            env[n.name] = residual_add_i8(env[n.inputs[0]],
                                          env[n.inputs[1]], n.relu)
    return env
