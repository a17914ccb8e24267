"""Image / feature / kernel decomposition planner (paper §5, Fig. 6).

Given a conv layer and an on-chip buffer budget, choose
  - an image tiling (tiles_h x tiles_w, with stride-aware halos),
  - a feature (output-channel) split, and
  - an input-channel split (kernel decomposition, partial sums)
such that the per-pass working set (input tile + output tile + weight
group) fits the budget, minimising off-chip (DRAM/HBM) traffic.

The same planner serves two parameterisations (DESIGN.md §6):
  * sram_budget = 128 KB, 16-bit words  -> the paper's ASIC (Fig. 6 plan)
  * sram_budget = VMEM working set      -> Pallas BlockSpec block shapes
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One CONV (optionally + POOL) layer, NHWC."""
    name: str
    in_h: int
    in_w: int
    in_c: int
    out_c: int
    kernel: int
    stride: int = 1
    pad: int = 0
    groups: int = 1        # grouped conv (AlexNet conv2/4/5 use 2)
    pool: int = 1          # fused max-pool window (1 = none)
    pool_stride: int = 0   # 0 -> = pool
    bytes_per_elem: int = 2  # 16-bit fixed point (paper)

    @property
    def out_h(self) -> int:
        return (self.in_h + 2 * self.pad - self.kernel) // self.stride + 1

    @property
    def out_w(self) -> int:
        return (self.in_w + 2 * self.pad - self.kernel) // self.stride + 1

    @property
    def pooled_h(self) -> int:
        if self.pool <= 1:
            return self.out_h
        ps = self.pool_stride or self.pool
        return (self.out_h - self.pool) // ps + 1

    @property
    def pooled_w(self) -> int:
        if self.pool <= 1:
            return self.out_w
        ps = self.pool_stride or self.pool
        return (self.out_w - self.pool) // ps + 1

    # ---- whole-layer quantities (paper Table 1 conventions) ----
    @property
    def macs(self) -> int:
        return (self.out_h * self.out_w * self.out_c
                * self.kernel * self.kernel * self.in_c) // self.groups

    @property
    def num_ops(self) -> int:
        return 2 * self.macs  # MAC = multiply + add (paper counts both)

    @property
    def in_bytes(self) -> int:
        return self.in_h * self.in_w * self.in_c * self.bytes_per_elem

    @property
    def out_bytes(self) -> int:
        return self.out_h * self.out_w * self.out_c * self.bytes_per_elem

    @property
    def weight_bytes(self) -> int:
        return (self.kernel * self.kernel * self.in_c * self.out_c
                * self.bytes_per_elem) // self.groups


@dataclasses.dataclass(frozen=True)
class Plan:
    layer: ConvLayer
    tiles_h: int
    tiles_w: int
    feat_splits: int        # output-channel groups
    in_splits: int          # input-channel groups (partial sums)
    # derived (bytes):
    in_tile_bytes: int
    out_tile_bytes: int
    weight_group_bytes: int
    psum_bytes: int
    dram_traffic: int       # total bytes moved off-chip for the layer
    passes: int

    @property
    def sram_needed(self) -> int:
        return (self.in_tile_bytes + self.out_tile_bytes
                + self.weight_group_bytes + self.psum_bytes)

    @property
    def overhead(self) -> float:
        """traffic / minimal traffic (in once + out once + weights once)."""
        l = self.layer
        ideal = l.in_bytes + l.out_bytes + l.weight_bytes
        return self.dram_traffic / ideal

    def describe(self) -> str:
        l = self.layer
        return (f"{l.name}: image {self.tiles_h}x{self.tiles_w}, "
                f"features /{self.feat_splits}, in-ch /{self.in_splits} | "
                f"in-tile {self.in_tile_bytes/1024:.1f}KB, "
                f"out-tile {self.out_tile_bytes/1024:.1f}KB, "
                f"weights {self.weight_group_bytes/1024:.1f}KB, "
                f"SRAM {self.sram_needed/1024:.1f}KB, "
                f"traffic x{self.overhead:.2f}")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def evaluate(layer: ConvLayer, tiles_h: int, tiles_w: int,
             feat_splits: int, in_splits: int) -> Optional[Plan]:
    """Buffer sizes + DRAM traffic for one decomposition choice.

    Streaming model (paper §3): for each image tile and each feature group,
    the input tile streams through the CU array once while that group's
    weights are resident; partial sums stay on-chip across in-channel
    groups (psum buffer).

    DRAM-traffic accounting (the quantity the planner minimises; the full
    derivation and its relation to the paper's Fig. 6 numbers is in
    DESIGN.md §6):

    * **Input re-read per feature group.** A feature group's weights must
      see every input pixel of the tile, and the on-chip buffer holds
      only one group's partial products, so the input tile is fetched
      from DRAM once per (image tile × feature group):
      ``in_traffic = in_tile_px * in_c * bytes * n_tiles * feat_splits``.
      In-channel splitting does NOT multiply input traffic — the c-groups
      of one tile pass partition the same fetched tile. For a grouped
      conv with feature splits, each feature group nests inside one conv
      group and fetches only its ``in_c / groups`` channel slice — the
      true footprint, not the block-diagonal view's full ``in_c``.
    * **Weights re-fetched per image tile.** Weights are resident across
      one tile's feature/in-channel walk but evicted between tiles (the
      weight buffer is sized for one group, not one layer):
      ``w_traffic = weight_bytes * n_tiles``. Feature/in-channel splits
      do not multiply weight traffic — each pass loads only its own
      slice, and the slices of one tile tile the whole tensor once.
    * **Output written exactly once.** Partial sums stay on-chip in the
      32-bit psum buffer across in-channel groups, so the output never
      round-trips: ``out_traffic = out_bytes``.

    Halo overlap between adjacent input tiles is counted as real traffic
    (tiles re-fetch their overlap rows), which is why ``overhead`` > 1
    even for pure image tiling.
    """
    l = layer
    if feat_splits > l.out_c or in_splits > l.in_c:
        return None
    if l.groups > 1:
        # grouped conv: feature groups must align with conv groups, and we
        # keep partial-sum splitting out of grouped layers for simplicity
        if in_splits != 1:
            return None
        if feat_splits > 1 and (feat_splits % l.groups != 0
                                or l.out_c % feat_splits != 0):
            # each feature block must nest inside one conv group; a ragged
            # split (e.g. 256 features / 24) straddles the group boundary
            # and would read the wrong input channels
            return None
    out_th = _ceil_div(l.out_h, tiles_h)
    out_tw = _ceil_div(l.out_w, tiles_w)
    # stride-aware input tile with halo (the column-buffer overlap)
    in_th = (out_th - 1) * l.stride + l.kernel
    in_tw = (out_tw - 1) * l.stride + l.kernel
    in_th = min(in_th, l.in_h + 2 * l.pad)
    in_tw = min(in_tw, l.in_w + 2 * l.pad)
    c_in_g = _ceil_div(l.in_c, in_splits)
    c_out_g = _ceil_div(l.out_c, feat_splits)

    # per-output-channel fan-in (grouped convs see in_c/groups inputs)
    fan_in = c_in_g if l.groups == 1 else l.in_c // l.groups
    # input channels resident per pass: a feature group of a grouped conv
    # only reads its own input-channel group
    eff_in_c = c_in_g if l.groups == 1 else (
        l.in_c // l.groups if feat_splits > 1 else l.in_c)
    in_tile = in_th * in_tw * eff_in_c * l.bytes_per_elem
    out_tile = out_th * out_tw * c_out_g * l.bytes_per_elem
    wg = l.kernel * l.kernel * fan_in * c_out_g * l.bytes_per_elem
    # partial sums held at accumulator precision (32-bit) across in-groups
    psum = out_th * out_tw * c_out_g * 4 if in_splits > 1 else 0

    n_tiles = tiles_h * tiles_w
    passes = n_tiles * feat_splits * in_splits
    # traffic: input tile re-read once per (feature group x in-group of it);
    # weights re-fetched once per image tile; output written once. A
    # grouped conv's feature group nests inside one conv group (the
    # alignment rule above), so each pass reads only that group's
    # in_c/groups channel slice — charging the full in_c here was the
    # block-diagonal view's phantom traffic.
    in_read_c = l.in_c if l.groups == 1 or feat_splits == 1 \
        else l.in_c // l.groups
    in_traffic = (in_th * in_tw * in_read_c * l.bytes_per_elem
                  * n_tiles * feat_splits)
    w_traffic = l.weight_bytes * n_tiles
    out_traffic = l.out_bytes
    return Plan(l, tiles_h, tiles_w, feat_splits, in_splits,
                in_tile, out_tile, wg, psum,
                in_traffic + w_traffic + out_traffic, passes)


def plan_decomposition(layer: ConvLayer, sram_budget: int,
                       max_tiles: int = 16) -> Plan:
    """Minimum-DRAM-traffic feasible decomposition (ties: fewer passes)."""
    best: Optional[Plan] = None
    feat_choices = sorted({1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64,
                           layer.out_c} | {layer.out_c})
    in_choices = sorted({1, 2, 3, 4, 8, 16, layer.in_c})
    for th, tw in itertools.product(range(1, max_tiles + 1), repeat=2):
        for fs in feat_choices:
            if fs > layer.out_c:
                continue
            for cs in in_choices:
                if cs > layer.in_c:
                    continue
                p = evaluate(layer, th, tw, fs, cs)
                if p is None or p.sram_needed > sram_budget:
                    continue
                key = (p.dram_traffic, p.passes, th * tw)
                if best is None or key < (best.dram_traffic, best.passes,
                                          best.tiles_h * best.tiles_w):
                    best = p
    if best is None:
        raise ValueError(
            f"{layer.name}: no feasible decomposition under "
            f"{sram_budget/1024:.0f} KB")
    return best


def tile_grid(layer: ConvLayer, plan: Plan):
    """Concrete (output-tile, input-window) coordinates for the executor.

    Yields dicts with output slice (oy, ox, oh, ow) and the input window
    (iy, ix, ih, iw) in *padded* input coordinates covering its halo."""
    l = layer
    out_th = _ceil_div(l.out_h, plan.tiles_h)
    out_tw = _ceil_div(l.out_w, plan.tiles_w)
    for ty in range(plan.tiles_h):
        for tx in range(plan.tiles_w):
            oy, ox = ty * out_th, tx * out_tw
            if oy >= l.out_h or ox >= l.out_w:
                continue
            oh = min(out_th, l.out_h - oy)
            ow = min(out_tw, l.out_w - ox)
            iy, ix = oy * l.stride, ox * l.stride
            ih = (oh - 1) * l.stride + l.kernel
            iw = (ow - 1) * l.stride + l.kernel
            yield dict(oy=oy, ox=ox, oh=oh, ow=ow,
                       iy=iy, ix=ix, ih=ih, iw=iw)


# ---------------------------------------------------------------------------
# AlexNet CONV layers (paper Table 1) — 16-bit words.
# ---------------------------------------------------------------------------

ALEXNET_LAYERS = (
    ConvLayer("conv1", 227, 227, 3, 96, 11, stride=4),
    ConvLayer("conv2", 27, 27, 96, 256, 5, pad=2, groups=2),
    ConvLayer("conv3", 13, 13, 256, 384, 3, pad=1),
    ConvLayer("conv4", 13, 13, 384, 384, 3, pad=1, groups=2),
    ConvLayer("conv5", 13, 13, 384, 256, 3, pad=1, groups=2),
)

# The paper's own Fig. 6 plan for conv1: image split 3x3 = 9, features /2.
PAPER_CONV1_PLAN = dict(tiles_h=3, tiles_w=3, feat_splits=2, in_splits=1)

# The chainable end-to-end stack: AlexNet's overlapping 3/2 max-pools after
# conv1/conv2/conv5 so each layer's output spatial dims feed the next
# layer's declared input (227 ->55 ->27 ->27 ->13 ->13 ->13 ->13 ->6).
# ALEXNET_LAYERS above keeps the paper's Table 1 per-layer conventions
# (no pooling in the op/storage counts); executors chain ALEXNET_STACK.
ALEXNET_STACK = tuple(
    dataclasses.replace(l, pool=3, pool_stride=2)
    if l.name in ("conv1", "conv2", "conv5") else l
    for l in ALEXNET_LAYERS)
