"""Static tile schedule — the command-decoder instruction stream in software.

The paper's accelerator (§3) owes its throughput to a *static* schedule:
the command decoder replays a fixed list of DMA + compute instructions
per layer, so the CU array never waits on control flow. This module is
the JAX analogue: it lowers a decomposition ``Plan`` (paper §5) into a
flat, array-encoded ``TileProgram`` whose per-step operands (input-window
offsets, output offsets, channel-group offsets) can be scanned by a
``lax.scan`` executor under ``jax.jit`` — one trace, zero per-tile Python.

Regularisation: ``lax.dynamic_slice`` needs static slice *sizes*, so the
program pads the (conv-padded) input and the output to a uniform tile
grid and pads channels up to whole groups. Every step then moves blocks
of identical shape — exactly the property that lets the paper's DMA
engine double-buffer (DESIGN.md §2). Padding is zeros, which contribute
exact 0.0 to every accumulation, so results match the ragged-tile
interpreter bit for bit; the executor crops the padding off at the end.

Instruction encoding (one row of ``operands()`` per step, int32):
  [iy, ix,  oy, ox,  c0, wc0, f0]
   input win  out tile  in-ch  weight-in-ch  out-ch offsets
Steps are ordered tile-major, feature-group middle, in-channel-group
innermost — the same walk as the interpreted executor, so partial-sum
accumulation order (and therefore rounding) is identical.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.decomposition import ConvLayer, Plan, _ceil_div
# the lowering/validation sites raise the runtime's typed taxonomy
# (each a ValueError subclass — pre-taxonomy callers are unaffected) so
# the fallback chain can attribute failures to a pipeline stage
from repro_torch.runtime.errors import LoweringError, PlanError


@dataclasses.dataclass(frozen=True)
class TileProgram:
    """A lowered, fully static schedule for one CONV layer.

    All geometry fields are Python ints (shape-static under jit); the
    per-step operand arrays live in ``steps`` as a host-side numpy array
    and are fed to the executor as a traced ``(n_steps, 7)`` int32 input,
    so one compiled executable can in principle replay any schedule of
    identical geometry.
    """
    layer: ConvLayer
    plan: Plan
    # padded-buffer geometry (static under jit)
    pad_h: int              # padded input height (conv pad + tile pad)
    pad_w: int
    in_c_pad: int           # input channels incl. group-rounding zeros
    w_in_pad: int           # weight fan-in dim incl. rounding zeros
    out_h_pad: int          # uniform-tile output height
    out_w_pad: int
    out_c_pad: int
    # per-step block shapes (static under jit)
    ih: int                 # input window rows (halo-inclusive)
    iw: int
    cg: int                 # input channels read per step
    fan: int                # weight fan-in per step
    fg: int                 # output channels written per step
    oh: int                 # output tile rows
    ow: int
    gcount: int             # feature_group_count of the per-step conv
    # the instruction stream
    steps: Tuple[Tuple[int, int, int, int, int, int, int], ...]

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    def operands(self) -> np.ndarray:
        """(n_steps, 7) int32 operand table for the scan executor."""
        return np.asarray(self.steps, np.int32)

    @property
    def geometry(self):
        """Hashable key of everything baked into the compiled executable."""
        return (self.layer, self.plan.tiles_h, self.plan.tiles_w,
                self.plan.feat_splits, self.plan.in_splits,
                self.pad_h, self.pad_w, self.in_c_pad, self.w_in_pad,
                self.out_h_pad, self.out_w_pad, self.out_c_pad,
                self.ih, self.iw, self.cg, self.fan, self.fg,
                self.oh, self.ow, self.gcount, self.n_steps)

    def describe(self) -> str:
        l = self.layer
        return (f"{l.name}: {self.n_steps} steps, "
                f"in-win {self.ih}x{self.iw}x{self.cg}, "
                f"out-tile {self.oh}x{self.ow}x{self.fg}, "
                f"weights {l.kernel}x{l.kernel}x{self.fan}x{self.fg}")


def compile_layer(layer: ConvLayer, plan: Plan) -> TileProgram:
    """Lower a Plan to a TileProgram (the §3 instruction stream).

    Mirrors the interpreted executor's channel-group rules exactly:
      * groups == 1: input channels split into ``in_splits`` groups of
        ``cg`` (partial sums), features into ``feat_splits`` groups;
      * groups > 1, feat_splits > 1: each feature group lies inside one
        conv group (planner-aligned) and reads only that group's inputs;
      * groups > 1, feat_splits == 1: one grouped conv per tile
        (``gcount = groups``), no channel slicing.
    """
    l = layer
    oth = _ceil_div(l.out_h, plan.tiles_h)
    otw = _ceil_div(l.out_w, plan.tiles_w)
    out_h_pad = plan.tiles_h * oth
    out_w_pad = plan.tiles_w * otw
    ih = (oth - 1) * l.stride + l.kernel
    iw = (otw - 1) * l.stride + l.kernel
    pad_h = (out_h_pad - 1) * l.stride + l.kernel
    pad_w = (out_w_pad - 1) * l.stride + l.kernel

    in_per_group = l.in_c // l.groups
    out_per_group = l.out_c // l.groups
    if l.groups == 1:
        cg = _ceil_div(l.in_c, plan.in_splits)
        fg = _ceil_div(l.out_c, plan.feat_splits)
        in_c_pad = plan.in_splits * cg
        out_c_pad = plan.feat_splits * fg
        w_in_pad = in_c_pad
        fan, gcount = cg, 1
        chan_steps = [(c * cg, c * cg) for c in range(plan.in_splits)]
    elif plan.feat_splits > 1:
        # planner guarantees in_splits == 1 and feat alignment with groups
        if l.out_c % plan.feat_splits or plan.feat_splits % l.groups:
            raise PlanError(
                f"{l.name}: feat_splits={plan.feat_splits} does not align "
                f"with groups={l.groups}")
        cg = fan = in_per_group
        fg = l.out_c // plan.feat_splits
        in_c_pad, out_c_pad, w_in_pad = l.in_c, l.out_c, in_per_group
        gcount = 1
        chan_steps = None  # c0 depends on the feature group, filled below
    else:
        cg, fan, fg = l.in_c, in_per_group, l.out_c
        in_c_pad, out_c_pad, w_in_pad = l.in_c, l.out_c, in_per_group
        gcount = l.groups
        chan_steps = [(0, 0)]

    steps = []
    for ty in range(plan.tiles_h):
        for tx in range(plan.tiles_w):
            oy, ox = ty * oth, tx * otw
            iy, ix = oy * l.stride, ox * l.stride
            for f in range(plan.feat_splits):
                f0 = f * fg
                if chan_steps is not None:
                    groups_of_f = chan_steps
                else:
                    g = f0 // out_per_group
                    groups_of_f = [(g * in_per_group, 0)]
                for c0, wc0 in groups_of_f:
                    steps.append((iy, ix, oy, ox, c0, wc0, f0))

    return TileProgram(
        layer=l, plan=plan, pad_h=pad_h, pad_w=pad_w,
        in_c_pad=in_c_pad, w_in_pad=w_in_pad,
        out_h_pad=out_h_pad, out_w_pad=out_w_pad, out_c_pad=out_c_pad,
        ih=ih, iw=iw, cg=cg, fan=fan, fg=fg, oh=oth, ow=otw,
        gcount=gcount, steps=tuple(steps))


def compile_network(layers: Sequence[ConvLayer],
                    plans: Sequence[Plan]) -> List[TileProgram]:
    """Lower a whole conv stack — one instruction stream per layer."""
    if len(layers) != len(plans):
        raise ValueError("layers and plans must pair up")
    return [compile_layer(l, p) for l, p in zip(layers, plans)]


# ---------------------------------------------------------------------------
# Wave partitioning — dependency-free dispatch groups
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WaveProgram:
    """A TileProgram re-cut into dependency-free *waves*.

    Two steps of a TileProgram depend on each other only when they write
    the same output block (a partial-sum chain over in-channel groups);
    steps with distinct ``(oy, ox, f0)`` are independent — the paper's
    observation that independent tiles can keep every CU busy while DMA
    double-buffers (§3). Wave ``k`` holds the ``k``-th step of every
    chain, so within a wave all output blocks are distinct and the wave
    can be dispatched as ONE batched conv; chains still accumulate in
    their original order across waves, so rounding matches the serial
    replay bit for bit.

    ``compile_layer`` orders steps tile-major / feature-middle /
    in-channel-innermost with equal-length chains, which makes every
    wave (a) the same size, (b) an exact raster tiling of the padded
    output, and (c) single-sourced per wave: every step of a wave reads
    the same input-channel group, so the wave's feature axis collapses
    into the conv's output-channel width and its tile axis into the
    batch axis — ONE ordinary (or ``groups``-grouped) conv per wave,
    encoded by ``tile_operands()``. ``partition_waves`` verifies all
    three; the wave executor's static reassembly (transpose instead of
    scatter) relies on them.
    """
    program: TileProgram
    n_waves: int            # == chain length (in_splits for ungrouped)
    wave_size: int          # steps per wave (tiles * feature groups)
    waves: Tuple[Tuple[Tuple[int, int, int, int, int, int, int], ...], ...]
    # per-wave, per-tile dispatch rows [iy, ix, oy, ox, c0, wc0]; the
    # feature axis is folded into the conv's output-channel width
    tile_waves: Tuple[Tuple[Tuple[int, int, int, int, int, int], ...], ...]
    # channel geometry of one wave dispatch (static under jit)
    c_width: int            # input channels read per dispatch
    fan_width: int          # weight fan-in sliced per dispatch
    dispatch_groups: int    # feature_group_count of the wave conv

    @property
    def n_tiles(self) -> int:
        return len(self.tile_waves[0])

    def operands(self) -> np.ndarray:
        """(n_waves, wave_size, 7) int32 step table (analysis/tests)."""
        return np.asarray(self.waves, np.int32)

    def tile_operands(self) -> np.ndarray:
        """(n_waves, n_tiles, 6) int32 dispatch table for the executor."""
        return np.asarray(self.tile_waves, np.int32)

    @property
    def geometry(self):
        return self.program.geometry + ("wave", self.n_waves,
                                        self.wave_size, self.c_width,
                                        self.fan_width, self.dispatch_groups)

    def describe(self) -> str:
        return (f"{self.program.layer.name}: {self.n_waves} wave(s) x "
                f"{self.n_tiles} tiles "
                f"({self.program.n_steps} serial steps fused)")


def partition_waves(program: TileProgram) -> WaveProgram:
    """Cut a TileProgram's step stream into dependency-free waves.

    A step's wave index is its position within its output-block chain
    (the number of earlier steps writing the same ``(oy, ox, f0)``), so
    by construction no wave contains two writers of one block and
    cross-wave order preserves every chain's accumulation order.
    """
    chain_pos: dict = {}
    waves: List[List[tuple]] = []
    for s in program.steps:
        key = (s[2], s[3], s[6])            # (oy, ox, f0)
        k = chain_pos.get(key, 0)
        chain_pos[key] = k + 1
        if k == len(waves):
            waves.append([])
        waves[k].append(s)

    sizes = {len(w) for w in waves}
    if len(sizes) > 1:
        raise LoweringError(
            f"{program.layer.name}: ragged waves {sorted(sizes)} — "
            f"chains of unequal length cannot batch into one dispatch")

    l = program.layer
    grouped = l.groups > 1
    tile_waves = []
    for k, wave in enumerate(waves):
        rows, seen = [], set()
        for s in wave:
            tile = (s[0], s[1], s[2], s[3])     # (iy, ix, oy, ox)
            if tile in seen:
                continue
            seen.add(tile)
            # grouped layers read the full channel width per dispatch
            # (the conv group structure routes each feature to its
            # inputs); ungrouped layers read this wave's channel group
            rows.append(tile + ((0, 0) if grouped else (s[4], s[5])))
        tile_waves.append(tuple(rows))

    wp = WaveProgram(
        program=program, n_waves=len(waves), wave_size=len(waves[0]),
        waves=tuple(tuple(w) for w in waves),
        tile_waves=tuple(tile_waves),
        c_width=program.in_c_pad if grouped else program.cg,
        fan_width=program.w_in_pad if grouped else program.cg,
        dispatch_groups=l.groups)
    validate_waves(wp)
    return wp


def validate_waves(wp: WaveProgram) -> None:
    """Check the invariants the wave executor's fused dispatch bakes in.

    1. No wave co-schedules two steps writing the same output block
       (independence — the property tests exercise this directly).
    2. Every wave lists blocks in raster order (tile-major, feature
       innermost) and exactly tiles the padded output, so stacked conv
       results reassemble by reshape/transpose with no scatter.
    3. Ungrouped layers: all steps of a wave read one input-channel
       group, so the feature axis can fold into the conv's output
       channels (grouped layers instead read the full width and let
       ``feature_group_count`` route features to their inputs).
    4. Tile windows are wave-invariant: wave ``k``'s dispatch rows name
       the same ``(iy, ix, oy, ox)`` windows (in the same order) as wave
       0 — only the channel offsets change along a chain. The wave
       executor's hoisted gather (slice each unique window once, then
       slice channels per wave) and the megakernel's per-tile operand
       columns both bake this in.
    """
    g, plan = wp.program, wp.program.plan
    expect = [(ty * g.oh, tx * g.ow, f * g.fg)
              for ty in range(plan.tiles_h)
              for tx in range(plan.tiles_w)
              for f in range(plan.feat_splits)]
    for k, wave in enumerate(wp.waves):
        blocks = [(s[2], s[3], s[6]) for s in wave]
        if len(set(blocks)) != len(blocks):
            dupes = {b for b in blocks if blocks.count(b) > 1}
            raise LoweringError(
                f"{g.layer.name} wave {k}: output blocks written twice "
                f"within one wave: {sorted(dupes)}")
        if blocks != expect:
            raise LoweringError(
                f"{g.layer.name} wave {k}: blocks deviate from the "
                f"raster tiling the batched reassembly assumes")
        if g.layer.groups == 1:
            chans = {(s[4], s[5]) for s in wave}
            if len(chans) != 1:
                raise LoweringError(
                    f"{g.layer.name} wave {k}: mixed input-channel "
                    f"groups {sorted(chans)} cannot fuse into one "
                    f"dispatch")
        tiles = [r[:4] for r in wp.tile_waves[k]]
        if tiles != [r[:4] for r in wp.tile_waves[0]]:
            raise LoweringError(
                f"{g.layer.name} wave {k}: tile windows differ from "
                f"wave 0 — the once-per-window gather and the "
                f"megakernel operand tables assume wave-invariant "
                f"windows")


def compile_layer_waves(layer: ConvLayer, plan: Plan) -> WaveProgram:
    """Lower straight to the wave-parallel form."""
    return partition_waves(compile_layer(layer, plan))


# ---------------------------------------------------------------------------
# Megakernel lowering — WaveProgram -> KernelProgram
# ---------------------------------------------------------------------------

# operand-table column layout (one row per (chain step, tile), int32):
#   IY, IX   input-window origin, elements into the padded input buffer
#   TY, TX   output block index (blocked: multiplied by the block shape)
#   C0, WC0  input-channel / weight fan-in offsets of the step's chunk
#   VR, VC   write mask: valid rows/cols of this tile's output block
KERNEL_OP_COLS = 8
(OP_IY, OP_IX, OP_TY, OP_TX, OP_C0, OP_WC0, OP_VR, OP_VC) = range(8)

# Default VMEM budget for chain coarsening and megakernel re-planning:
# half a TPU core's ~16 MB VMEM, leaving room for double-buffered
# windows and the output block.
DEFAULT_VMEM_BUDGET = 8 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class KernelProgram:
    """A WaveProgram lowered for the persistent Pallas megakernel.

    The whole layer becomes ONE ``pallas_call`` whose grid iterates
    (tile, wave): the wave (in-channel-group) axis is innermost, so a
    VMEM scratch accumulator plays the paper's partial-sum SRAM bank —
    it is zeroed when a tile's chain starts (wave 0) and carried across
    the chain with **zero HBM round-trips**; the epilogue (bias + optional
    ReLU + optional fused max-pool, masked write) runs on the last wave
    (kernels/wave_replay). The operand ``table`` is the §3 command
    stream: a static int32 array prefetched to SMEM whose rows steer
    every DMA (window origin, channel-group offsets, output block index,
    write mask) — index maps read it, never the tensor data.

    The grid is rectangular by construction: ``partition_waves``
    guarantees equal-size waves with wave-invariant tile windows
    (``validate_waves`` invariant 4), so the table is a dense
    ``(n_chain, n_tiles, 8)`` block with no ragged padding rows.

    Chain coarsening: the plan's ``in_splits`` was sized for the paper's
    128 KB SRAM, but the megakernel's scratch is real VMEM (~16 MB), so
    the lowering re-runs the planner's budget math at the kernel's
    budget point (DESIGN.md §6) and folds ``chain_chunk`` consecutive
    schedule waves into each grid step — the CU array's Tn-wide
    input-channel parallelism, in software. Chunks accumulate in chain
    order; within a chunk the reduction happens inside one im2col
    matmul, so coarsened outputs match the serial replay to fp32
    tolerance rather than bit-exactly (``vmem_budget=None`` disables
    coarsening for 1:1 replays).

    With ``fuse_pool`` the tile geometry is re-derived over the *pooled*
    output (the fused_conv_pool trick): each tile's accumulator covers
    exactly the conv rows its pooled rows need (``acc = (blk-1)*ps +
    pool``), re-computing the (pool - stride)-row overlap between
    adjacent tiles instead of exchanging it — the conv->pool
    intermediate never exists outside VMEM.
    """
    wave: WaveProgram
    relu: bool
    fuse_pool: bool
    # residual epilogue: the kernel takes one extra operand —
    # a pre-computed activation of the layer's OWN output geometry —
    # and adds it to the accumulator right after bias, before ReLU: the
    # paper's accumulation-SRAM add. Mutually exclusive with fuse_pool
    # (pooling a pre-add activation would change shapes under the add).
    residual: bool
    # padded input-buffer geometry (static under jit)
    pad_h: int
    pad_w: int
    in_c_kpad: int          # input channels incl. chain-chunk rounding
    w_in_kpad: int          # weight fan-in incl. chain-chunk rounding
    # per-grid-step block geometry
    ih: int                 # input-window rows (halo-inclusive)
    iw: int
    acc_h: int              # conv rows accumulated per tile (VMEM scratch)
    acc_w: int
    blk_h: int              # output block per tile (pooled if fuse_pool)
    blk_w: int
    c_width: int            # input channels read per step
    fan_width: int          # weight fan-in sliced per step
    out_c_pad: int
    groups: int             # conv groups executed inside the kernel body
    pool: int               # epilogue pool window (1 = bias/ReLU only)
    pool_stride: int
    # valid (cropped) output dims
    out_h: int
    out_w: int
    chain_chunk: int        # schedule waves folded per grid step
    n_chain: int            # grid steps per tile chain
    n_tiles: int
    table: Tuple[Tuple[Tuple[int, ...], ...], ...]
    # batch axis as a first-class grid dimension: images
    # processed per grid step. The kernel grid iterates (batch-block,
    # tile, chain); a runtime batch B launches ceil(B / batch_block)
    # batch blocks (``batch_grid``). The default 1 keeps per-image
    # working sets; batch-aware lowering raises it until the per-step
    # VMEM working set fills the budget.
    batch_block: int = 1

    def operand_table(self) -> np.ndarray:
        """(n_chain, n_tiles, 8) int32 SMEM operand table."""
        return np.asarray(self.table, np.int32)

    @property
    def tiles_h(self) -> int:
        return self.wave.program.plan.tiles_h

    @property
    def tiles_w(self) -> int:
        return self.wave.program.plan.tiles_w

    @property
    def out_h_pad(self) -> int:
        return self.tiles_h * self.blk_h

    @property
    def out_w_pad(self) -> int:
        return self.tiles_w * self.blk_w

    @property
    def vmem_bytes(self) -> int:
        """Per-grid-step fp32 working set: ``batch_block`` images'
        accumulators + input-window chunks (+ residual blocks when the
        epilogue adds them) plus the batch-shared weight chunk — what
        ``vmem_budget`` bounds."""
        l = self.wave.program.layer
        return 4 * (self.batch_block
                    * (self.acc_h * self.acc_w * self.out_c_pad
                       + self.ih * self.iw * self.c_width
                       + (self.blk_h * self.blk_w * self.out_c_pad
                          if self.residual else 0))
                    + l.kernel * l.kernel * self.fan_width
                    * self.out_c_pad)

    @property
    def geometry(self):
        """The table is a pure function of these, so they key the cache."""
        return self.wave.geometry + (
            "megakernel", self.relu, self.fuse_pool, self.residual,
            self.pad_h, self.pad_w,
            self.in_c_kpad, self.w_in_kpad,
            self.ih, self.iw, self.acc_h, self.acc_w, self.blk_h, self.blk_w,
            self.c_width, self.fan_width, self.out_c_pad, self.groups,
            self.pool, self.pool_stride, self.out_h, self.out_w,
            self.chain_chunk, self.n_chain, self.batch_block)

    def describe(self) -> str:
        l = self.wave.program.layer
        fused = f"+pool{self.pool}/{self.pool_stride}" if self.fuse_pool \
            else ""
        fused += "+residual" if self.residual else ""
        chunk = f" (x{self.chain_chunk} waves/step)" \
            if self.chain_chunk > 1 else ""
        chunk += f" x{self.batch_block} imgs/step" \
            if self.batch_block > 1 else ""
        return (f"{l.name}: 1 pallas_call, grid {self.n_tiles}x"
                f"{self.n_chain} (tile x chain{chunk}), acc {self.acc_h}x"
                f"{self.acc_w}x{self.out_c_pad} VMEM"
                f"{fused}, table {self.n_chain}x{self.n_tiles}x"
                f"{KERNEL_OP_COLS} SMEM")


def batch_grid(batch: int, batch_block: int) -> Tuple[int, int]:
    """Split a runtime batch into ``(n_blocks, block)`` grid factors.

    The kernels iterate the batch axis as their outermost grid
    dimension in blocks of ``block = min(batch_block, batch)`` images;
    ragged batches are zero-padded up to ``n_blocks * block`` by the
    launchers (zero images convolve to exact zeros) and cropped on
    return. Per-image independence of the im2col matmul rows makes the
    split invisible numerically — only VMEM footprint and launch count
    change.
    """
    if batch < 1:
        raise ValueError(f"batch {batch} < 1")
    bb = max(1, min(int(batch_block), batch))
    return _ceil_div(batch, bb), bb


def lower_kernel_program(
        wprog: WaveProgram, *, relu: bool = False, fuse_pool: bool = False,
        residual: bool = False,
        vmem_budget: "int | None" = DEFAULT_VMEM_BUDGET,
        batch_block: int = 1) -> KernelProgram:
    """Lower a WaveProgram to the megakernel's static operand tables.

    ``relu`` bakes max(x, 0) into the epilogue; ``fuse_pool`` additionally
    max-pools the accumulator in VMEM (requires ``layer.pool > 1``) and
    re-derives the tile grid over the pooled output. ``residual`` adds
    an extra same-geometry operand to the accumulator after bias and
    before ReLU (the residual accumulation-buffer add; incompatible
    with ``fuse_pool``). ``vmem_budget`` bounds the per-step VMEM
    working set (accumulator + input-window chunk + weight chunk, fp32)
    used to coarsen long partial-sum chains; ``None`` keeps the
    schedule's 1:1 wave chain (bit-faithful replay). ``batch_block``
    asks for that many images per grid step; it is clamped so
    a single-wave step still fits the budget — the batch-scaled terms
    (accumulator, input window, residual block) are per image, the
    weight chunk is shared.
    """
    g = wprog.program
    l, plan = g.layer, g.plan
    if fuse_pool and l.pool <= 1:
        raise LoweringError(f"{l.name}: fuse_pool on a layer without a pool")
    if residual and fuse_pool:
        raise LoweringError(
            f"{l.name}: residual add cannot fuse with the pool epilogue "
            f"— the add runs on the conv-geometry accumulator")

    if fuse_pool:
        ps = l.pool_stride or l.pool
        if l.pooled_h < 1 or l.pooled_w < 1:
            raise LoweringError(
                f"{l.name}: conv output {l.out_h}x{l.out_w} smaller than "
                f"pool {l.pool}")
        blk_h = _ceil_div(l.pooled_h, plan.tiles_h)
        blk_w = _ceil_div(l.pooled_w, plan.tiles_w)
        acc_h = (blk_h - 1) * ps + l.pool
        acc_w = (blk_w - 1) * ps + l.pool
        ih = (acc_h - 1) * l.stride + l.kernel
        iw = (acc_w - 1) * l.stride + l.kernel
        pad_h = (plan.tiles_h - 1) * blk_h * ps * l.stride + ih
        pad_w = (plan.tiles_w - 1) * blk_w * ps * l.stride + iw
        out_h, out_w = l.pooled_h, l.pooled_w
        pool = l.pool
    else:
        ps, pool = 1, 1
        blk_h = acc_h = g.oh
        blk_w = acc_w = g.ow
        ih, iw = g.ih, g.iw
        pad_h, pad_w = g.pad_h, g.pad_w
        out_h, out_w = l.out_h, l.out_w

    # batch-block clamp: bb images per grid step must fit the budget
    # even at chunk = 1 — the weight chunk is batch-shared, everything
    # else (accumulator, input window, residual block) scales per image
    bb = max(1, int(batch_block))
    if bb > 1 and vmem_budget is not None:
        w1 = l.kernel * l.kernel * wprog.fan_width * g.out_c_pad * 4
        per_img = 4 * (acc_h * acc_w * g.out_c_pad
                       + ih * iw * wprog.c_width
                       + (blk_h * blk_w * g.out_c_pad if residual else 0))
        fit = (vmem_budget - w1) // per_img if vmem_budget > w1 else 1
        bb = max(1, min(bb, fit))

    # chain coarsening: fold `chunk` consecutive waves per grid step so
    # the per-step working set fills (but stays under) the kernel's VMEM
    # budget — the planner's feasibility math re-run at the VMEM budget
    # point. Grouped layers have single-step chains; nothing to fold.
    chunk = 1
    if wprog.n_waves > 1 and vmem_budget is not None:
        acc_bytes = bb * acc_h * acc_w * g.out_c_pad * 4
        per_wave = (bb * ih * iw * wprog.c_width * 4
                    + l.kernel * l.kernel * wprog.fan_width
                    * g.out_c_pad * 4)
        if vmem_budget > acc_bytes + per_wave:
            chunk = min(wprog.n_waves,
                        (vmem_budget - acc_bytes) // per_wave)
        chunk = max(1, chunk)
    n_chain = _ceil_div(wprog.n_waves, chunk)
    c_width = wprog.c_width * chunk
    # ungrouped layers run one dense matmul per step, so the weight fan
    # equals the input-channel width; grouped layers keep the natural
    # per-group fan (``in_c // groups`` — the wave program's fan_width):
    # the kernel body accumulates each group's Cin/g x Cout/g slice (or
    # the depthwise MAC epilogue) without materialising the
    # block-diagonal zeros
    fan_width = c_width if l.groups == 1 else wprog.fan_width
    # round the channel axes up to whole chunks (zeros accumulate 0.0)
    in_c_kpad = max(g.in_c_pad, n_chain * c_width) if chunk > 1 \
        else g.in_c_pad
    w_in_kpad = in_c_kpad if l.groups == 1 else wprog.fan_width

    table = []
    for j in range(n_chain):
        rows = wprog.tile_waves[j * chunk]
        c0, wc0 = rows[0][4], rows[0][5]
        step_rows = []
        i = 0
        for ty in range(plan.tiles_h):
            for tx in range(plan.tiles_w):
                if fuse_pool:
                    iy = ty * blk_h * ps * l.stride
                    ix = tx * blk_w * ps * l.stride
                else:
                    # reuse the wave rows (raster order per invariant 2/4)
                    iy, ix = rows[i][0], rows[i][1]
                    if (rows[i][2], rows[i][3]) != (ty * blk_h, tx * blk_w):
                        raise LoweringError(
                            f"{l.name}: wave {j * chunk} tile {i} out of "
                            f"raster order — cannot index a rectangular "
                            f"grid")
                vr = max(0, min(blk_h, out_h - ty * blk_h))
                vc = max(0, min(blk_w, out_w - tx * blk_w))
                step_rows.append((iy, ix, ty, tx, c0, wc0, vr, vc))
                i += 1
        table.append(tuple(step_rows))

    kp = KernelProgram(
        wave=wprog, relu=relu, fuse_pool=fuse_pool, residual=residual,
        pad_h=pad_h, pad_w=pad_w,
        in_c_kpad=in_c_kpad, w_in_kpad=w_in_kpad,
        ih=ih, iw=iw,
        acc_h=acc_h, acc_w=acc_w, blk_h=blk_h, blk_w=blk_w,
        c_width=c_width, fan_width=fan_width,
        out_c_pad=g.out_c_pad, groups=l.groups,
        pool=pool, pool_stride=ps, out_h=out_h, out_w=out_w,
        chain_chunk=chunk, n_chain=n_chain, n_tiles=wprog.n_tiles,
        table=tuple(table), batch_block=bb)
    validate_kernel_program(kp)
    return kp


def validate_kernel_program(kp: KernelProgram) -> None:
    """Check the invariants the persistent kernel's grid bakes in.

    1. The table is a dense rectangular (n_chain, n_tiles, 8) block and
       the chain covers every schedule wave exactly once
       (``n_chain * chain_chunk >= n_waves``, no overlap).
    2. Every input window, channel chunk, and weight slice lies inside
       the padded buffers — a stale offset would make the kernel's
       unblocked DMA read out of bounds.
    3. Output block indices raster-tile the padded output exactly once
       per chain step, and the write masks cover the valid output
       exactly: per tile column the VR masks sum to out_h, per row VC
       to out_w.
    4. Channel offsets are constant within a step and walk the chain in
       order (step j reads chunk j — the VMEM accumulator assumes grid
       step j holds chain position j of every tile).
    """
    g = kp.wave.program
    l, plan = g.layer, g.plan
    tab = kp.operand_table()
    if tab.shape != (kp.n_chain, kp.n_tiles, KERNEL_OP_COLS):
        raise LoweringError(
            f"{l.name}: operand table {tab.shape} is not the dense "
            f"({kp.n_chain}, {kp.n_tiles}, {KERNEL_OP_COLS}) grid")
    if kp.n_chain * kp.chain_chunk < kp.wave.n_waves:
        raise LoweringError(
            f"{l.name}: {kp.n_chain} steps x chunk {kp.chain_chunk} "
            f"drop waves of the {kp.wave.n_waves}-long chain")
    expect_blocks = [(ty, tx) for ty in range(plan.tiles_h)
                     for tx in range(plan.tiles_w)]
    for j in range(kp.n_chain):
        rows = tab[j]
        if [(r[OP_TY], r[OP_TX]) for r in rows] != expect_blocks:
            raise LoweringError(
                f"{l.name} step {j}: output blocks deviate from the "
                f"raster tiling")
        c0s = {(r[OP_C0], r[OP_WC0]) for r in rows}
        if len(c0s) != 1:
            raise LoweringError(
                f"{l.name} step {j}: mixed channel offsets {sorted(c0s)}")
        if l.groups == 1 and c0s != {(j * kp.c_width, j * kp.fan_width)}:
            raise LoweringError(
                f"{l.name} step {j}: channel offsets {sorted(c0s)} break "
                f"chain order (expected chunk {j} at {j * kp.c_width})")
        if l.groups > 1 and c0s != {(0, 0)}:
            raise LoweringError(
                f"{l.name} step {j}: grouped layers read the full "
                f"channel width at offset 0, got {sorted(c0s)}")
        for r in rows:
            if not (0 <= r[OP_IY] and r[OP_IY] + kp.ih <= kp.pad_h
                    and 0 <= r[OP_IX] and r[OP_IX] + kp.iw <= kp.pad_w):
                raise LoweringError(
                    f"{l.name} step {j}: input window ({r[OP_IY]}, "
                    f"{r[OP_IX]})+({kp.ih}, {kp.iw}) outside the padded "
                    f"({kp.pad_h}, {kp.pad_w}) buffer")
            if r[OP_C0] + kp.c_width > kp.in_c_kpad:
                raise LoweringError(
                    f"{l.name} step {j}: channel offset {r[OP_C0]} + "
                    f"width {kp.c_width} exceeds {kp.in_c_kpad}")
            if r[OP_WC0] + kp.fan_width > kp.w_in_kpad:
                raise LoweringError(
                    f"{l.name} step {j}: weight fan offset {r[OP_WC0]} "
                    f"+ {kp.fan_width} exceeds {kp.w_in_kpad}")
    # masks tile the valid output exactly (step 0 suffices: masks are
    # chain-invariant by construction)
    vr_sum = sum(int(tab[0][ty * plan.tiles_w][OP_VR])
                 for ty in range(plan.tiles_h))
    vc_sum = sum(int(tab[0][tx][OP_VC]) for tx in range(plan.tiles_w))
    if vr_sum != kp.out_h or vc_sum != kp.out_w:
        raise LoweringError(
            f"{l.name}: write masks cover {vr_sum}x{vc_sum}, valid "
            f"output is {kp.out_h}x{kp.out_w}")
