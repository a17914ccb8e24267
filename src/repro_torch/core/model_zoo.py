"""The other networks the paper claims to support ("able to support
most popular CNNs"): VGG-16, ResNet-18, and the MobileNets.

Two representations live here:

  * the flat CONV-layer tables (``VGG16_LAYERS`` / ``RESNET18_LAYERS``)
    — the *distinct* conv shapes at nameplate 224x224 resolution, used
    by the planner benchmarks to show every shape decomposes under the
    128 KB budget (paper Fig. 6 methodology);
  * full **NetworkGraph** programs (``vgg16_graph`` / ``resnet18_graph``,
    core/graph.py) — every layer instance wired by named activation
    edges, residual adds and 1x1 projection shortcuts included, which
    is what the executors actually run end to end. Both builders are
    resolution/width-parameterised so tests exercise the full topology
    at CPU-friendly scale while benchmarks keep nameplate dims.

``network_graph(name)`` is the registry the serving layer uses.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.decomposition import ALEXNET_STACK, ConvLayer
from repro_torch.core.graph import INPUT, GraphNode, NetworkGraph, chain_graph

# VGG-16 conv layers (Simonyan & Zisserman 2014), 224x224 input.
VGG16_LAYERS = (
    ConvLayer("vgg_c1_1", 224, 224, 3, 64, 3, pad=1),
    ConvLayer("vgg_c1_2", 224, 224, 64, 64, 3, pad=1, pool=2),
    ConvLayer("vgg_c2_1", 112, 112, 64, 128, 3, pad=1),
    ConvLayer("vgg_c2_2", 112, 112, 128, 128, 3, pad=1, pool=2),
    ConvLayer("vgg_c3_1", 56, 56, 128, 256, 3, pad=1),
    ConvLayer("vgg_c3_2", 56, 56, 256, 256, 3, pad=1),
    ConvLayer("vgg_c3_3", 56, 56, 256, 256, 3, pad=1, pool=2),
    ConvLayer("vgg_c4_1", 28, 28, 256, 512, 3, pad=1),
    ConvLayer("vgg_c4_2", 28, 28, 512, 512, 3, pad=1),
    ConvLayer("vgg_c4_3", 28, 28, 512, 512, 3, pad=1, pool=2),
    ConvLayer("vgg_c5_1", 14, 14, 512, 512, 3, pad=1),
    ConvLayer("vgg_c5_2", 14, 14, 512, 512, 3, pad=1),
    ConvLayer("vgg_c5_3", 14, 14, 512, 512, 3, pad=1, pool=2),
)

# ResNet-18 conv layers (He et al. 2015) — the distinct conv shapes at
# canonical dims; the runnable graph below derives every instance's
# dims from the actual stem arithmetic instead.
RESNET18_LAYERS = (
    ConvLayer("res_conv1", 224, 224, 3, 64, 7, stride=2, pad=3, pool=3,
              pool_stride=2),
    ConvLayer("res_b1", 56, 56, 64, 64, 3, pad=1),
    ConvLayer("res_b2_down", 56, 56, 64, 128, 3, stride=2, pad=1),
    ConvLayer("res_b2", 28, 28, 128, 128, 3, pad=1),
    ConvLayer("res_b3_down", 28, 28, 128, 256, 3, stride=2, pad=1),
    ConvLayer("res_b3", 14, 14, 256, 256, 3, pad=1),
    ConvLayer("res_b4_down", 14, 14, 256, 512, 3, stride=2, pad=1),
    ConvLayer("res_b4", 7, 7, 512, 512, 3, pad=1),
    # 1x1 projection shortcuts
    ConvLayer("res_proj2", 56, 56, 64, 128, 1, stride=2),
    ConvLayer("res_proj3", 28, 28, 128, 256, 1, stride=2),
    ConvLayer("res_proj4", 14, 14, 256, 512, 1, stride=2),
)


# ---------------------------------------------------------------------------
# Full NetworkGraph programs
# ---------------------------------------------------------------------------

def _conv_out(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def vgg16_graph(in_hw: int = 224, width: int = 64,
                name: str = "vgg16") -> NetworkGraph:
    """All 13 VGG-16 convs as a linear graph; stage widths scale with
    ``width`` (64 = nameplate), spatial dims with ``in_hw``. Max-pools
    ride on the last conv of each stage (the fused-pool layers)."""
    stages = [(width, 2), (2 * width, 2), (4 * width, 3),
              (8 * width, 3), (8 * width, 3)]
    layers: List[ConvLayer] = []
    h, c = in_hw, 3
    for si, (w_out, reps) in enumerate(stages, start=1):
        for ri in range(1, reps + 1):
            pool = 2 if ri == reps else 1
            layers.append(ConvLayer(f"c{si}_{ri}", h, h, c, w_out, 3,
                                    pad=1, pool=pool))
            c = w_out
        h //= 2
        if h < 1:
            raise ValueError(f"vgg16: input {in_hw} too small for five "
                             f"2x pools")
    return chain_graph(layers, name=name)


def resnet18_graph(in_hw: int = 224, width: int = 64,
                   name: str = "resnet18") -> NetworkGraph:
    """Full ResNet-18: 7x7/2 stem with 3/2 max-pool, four stages of two
    basic blocks (3x3 conv pairs + identity shortcut), stages 2-4 led
    by a stride-2 block whose shortcut is a 1x1 stride-2 projection
    conv. Residual adds are ``add`` nodes (fused into the producing
    conv's megakernel epilogue by ``residual_fusion``); projections are
    ordinary streamed conv nodes. Spatial dims follow the repo's
    unpadded 3/2 pool arithmetic (224 -> 112 -> 55 at the stem).
    """
    nodes: List[GraphNode] = []
    h = _conv_out(in_hw, 7, 2, 3)
    nodes.append(GraphNode(
        "stem", "conv", (INPUT,),
        layer=ConvLayer("stem", in_hw, in_hw, 3, width, 7, stride=2,
                        pad=3, pool=3, pool_stride=2)))
    h = (h - 3) // 2 + 1                      # the stem's 3/2 pool
    prev, c = "stem", width

    def block(tag: str, h: int, cin: int, cout: int, stride: int,
              prev: str) -> "tuple[str, int]":
        ho = _conv_out(h, 3, stride, 1)
        nodes.append(GraphNode(
            f"{tag}_c1", "conv", (prev,),
            layer=ConvLayer(f"{tag}_c1", h, h, cin, cout, 3,
                            stride=stride, pad=1)))
        nodes.append(GraphNode(
            f"{tag}_c2", "conv", (f"{tag}_c1",),
            layer=ConvLayer(f"{tag}_c2", ho, ho, cout, cout, 3, pad=1),
            relu=False))                       # block ReLU lives on the add
        if stride != 1 or cin != cout:
            nodes.append(GraphNode(
                f"{tag}_proj", "conv", (prev,),
                layer=ConvLayer(f"{tag}_proj", h, h, cin, cout, 1,
                                stride=stride),
                relu=False))
            shortcut = f"{tag}_proj"
        else:
            shortcut = prev
        nodes.append(GraphNode(f"{tag}_add", "add",
                               (f"{tag}_c2", shortcut)))
        return f"{tag}_add", ho

    for si, mult in enumerate((1, 2, 4, 8), start=1):
        cout = width * mult
        stride = 1 if si == 1 else 2
        prev, h = block(f"s{si}b1", h, c, cout, stride, prev)
        prev, h = block(f"s{si}b2", h, cout, cout, 1, prev)
        c = cout
        if h < 1:
            raise ValueError(f"resnet18: input {in_hw} too small")
    return NetworkGraph(name=name, in_shape=(in_hw, in_hw, 3),
                        nodes=tuple(nodes), output=prev)


def alexnet_graph(name: str = "alexnet") -> NetworkGraph:
    """The pooled AlexNet stack as a (linear) NetworkGraph."""
    return chain_graph(ALEXNET_STACK, name=name)


def facedet_graph(in_hw: int = 16, width: int = 8, depth: int = 14,
                  name: str = "facedet") -> NetworkGraph:
    """Compact sliding-window detector — the paper's §7 deployment
    shape (a small face-detection CNN classifying tiny frames at high
    request rate). A strided 3x3 stem with a 2x2 pool knocks the window
    down fast, a second pool follows the first trunk pair, then a deep
    trunk of alternating 1x1/3x3 convs runs at tiny spatial dims. At
    this scale per-image conv compute is small and the per-launch /
    per-dispatch overhead of ``depth`` kernels dominates a batch=1
    forward — the regime the batch-axis grid dimension exists
    for, and the batched-throughput curve the bench gates rides this
    graph."""
    if depth < 4:
        raise ValueError(f"facedet: depth {depth} < 4")
    layers: List[ConvLayer] = []
    h, c = in_hw, 3
    stem = ConvLayer("c1", h, h, c, width, 3, stride=2, pad=1, pool=2)
    layers.append(stem)
    h, c = stem.out_h // 2, width
    for i in range(2, depth + 1):
        pool = 2 if i == 3 else 1
        out_c = 4 * width if i > 3 else 2 * width
        k = 3 if i % 2 else 1
        l = ConvLayer(f"c{i}", h, h, c, out_c, k,
                      pad=(1 if k == 3 else 0), pool=pool)
        layers.append(l)
        h, c = l.out_h // pool, out_c
        if h < 1:
            raise ValueError(f"facedet: input {in_hw} too small for "
                             f"depth {depth}")
    return chain_graph(tuple(layers), name=name)


def mobilenet_v1_graph(in_hw: int = 224, width: int = 32,
                       name: str = "mobilenet_v1") -> NetworkGraph:
    """MobileNet-v1 (Howard et al. 2017): a 3x3/2 stem then 13
    depthwise-separable blocks — a 3x3 depthwise conv (``groups ==
    Cin``, the paper's per-channel feature decomposition taken to its
    limit) followed by a 1x1 pointwise conv. Channel widths scale with
    ``width`` (32 = nameplate, topping out at ``32 * width``), spatial
    dims with ``in_hw``. A linear graph — no residuals — whose grouped
    nodes are what the natural per-group megakernel path
    exists for: block-diagonal expansion would pay ``Cin``x the real
    depthwise flops and weight DMA.
    """
    # (depthwise stride, pointwise out-channels in units of ``width``)
    blocks = ((1, 2), (2, 4), (1, 4), (2, 8), (1, 8), (2, 16),
              (1, 16), (1, 16), (1, 16), (1, 16), (1, 16),
              (2, 32), (1, 32))
    layers: List[ConvLayer] = [
        ConvLayer("stem", in_hw, in_hw, 3, width, 3, stride=2, pad=1)]
    h, c = _conv_out(in_hw, 3, 2, 1), width
    for i, (s, mult) in enumerate(blocks, start=1):
        ho = _conv_out(h, 3, s, 1)
        if ho < 1:
            raise ValueError(f"mobilenet_v1: input {in_hw} too small "
                             f"for block {i}")
        layers.append(ConvLayer(f"dw{i}", h, h, c, c, 3, stride=s,
                                pad=1, groups=c))
        layers.append(ConvLayer(f"pw{i}", ho, ho, c, width * mult, 1))
        h, c = ho, width * mult
    return chain_graph(tuple(layers), name=name)


def mobilenet_v2_graph(in_hw: int = 224, width: int = 32,
                       name: str = "mobilenet_v2") -> NetworkGraph:
    """MobileNet-v2 (Sandler et al. 2018): inverted residual blocks —
    1x1 expand (ReLU), 3x3 depthwise (ReLU), 1x1 *linear* project — with
    identity shortcuts when stride is 1 and channels match. The linear
    bottleneck means both the projection conv AND the residual add carry
    ``relu=False``, exercising the megakernels' no-ReLU residual-fusion
    epilogue. Channel widths scale by ``width / 32`` (32 = nameplate).
    """
    def sc(c: int) -> int:
        return max(2, (c * width) // 32)

    nodes: List[GraphNode] = [GraphNode(
        "stem", "conv", (INPUT,),
        layer=ConvLayer("stem", in_hw, in_hw, 3, sc(32), 3, stride=2,
                        pad=1))]
    prev, h, c = "stem", _conv_out(in_hw, 3, 2, 1), sc(32)
    # (expansion t, nameplate out-channels, repeats, first-rep stride)
    spec = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
    bi = 0
    for t, cref, reps, s in spec:
        cout = sc(cref)
        for r in range(reps):
            bi += 1
            tag = f"b{bi}"
            stride = s if r == 0 else 1
            ho = _conv_out(h, 3, stride, 1)
            if ho < 1:
                raise ValueError(f"mobilenet_v2: input {in_hw} too "
                                 f"small for block {bi}")
            ce, inp = c * t, prev
            if t > 1:
                nodes.append(GraphNode(
                    f"{tag}_exp", "conv", (prev,),
                    layer=ConvLayer(f"{tag}_exp", h, h, c, ce, 1)))
                inp = f"{tag}_exp"
            nodes.append(GraphNode(
                f"{tag}_dw", "conv", (inp,),
                layer=ConvLayer(f"{tag}_dw", h, h, ce, ce, 3,
                                stride=stride, pad=1, groups=ce)))
            nodes.append(GraphNode(
                f"{tag}_proj", "conv", (f"{tag}_dw",),
                layer=ConvLayer(f"{tag}_proj", ho, ho, ce, cout, 1),
                relu=False))                   # linear bottleneck
            out = f"{tag}_proj"
            if stride == 1 and c == cout:
                nodes.append(GraphNode(f"{tag}_add", "add",
                                       (f"{tag}_proj", prev),
                                       relu=False))
                out = f"{tag}_add"
            prev, h, c = out, ho, cout
    nodes.append(GraphNode(
        "head", "conv", (prev,),
        layer=ConvLayer("head", h, h, c, sc(1280), 1)))
    return NetworkGraph(name=name, in_shape=(in_hw, in_hw, 3),
                        nodes=tuple(nodes), output="head")


def network_graph(name: str, **kw) -> NetworkGraph:
    """Registry entry point for serving/benchmarks: name -> graph."""
    try:
        return NETWORKS[name](**kw)
    except KeyError:
        raise ValueError(f"unknown network {name!r} "
                         f"(have {sorted(NETWORKS)})") from None


NETWORKS = {
    "alexnet": alexnet_graph,
    "vgg16": vgg16_graph,
    "resnet18": resnet18_graph,
    "facedet": facedet_graph,
    "mobilenet_v1": mobilenet_v1_graph,
    "mobilenet_v2": mobilenet_v2_graph,
}
