"""Streaming executors: the layer executors and the graph executor in
every mode (paper §3 + §5 combined).

The counterpart of ``repro/core/streaming.py``. Every conv node of a
``NetworkGraph`` is planned (``plan_graph``) and lowered to a
``TileProgram`` (``compile_graph``); the executors replay it:

  * ``mode="interpret"``: the Python triple loop over ``tile_grid``
    (``run_layer_interpreted``), one conv per pass. The reference walk.
  * ``mode="scan"`` (alias ``"jit"``): the ``TileProgram``'s step table
    replayed in a Python loop (``_scan_executor``), one conv per step
    added into an fp32 output buffer.
  * ``mode="wave"``: the step stream cut into dependency-free waves
    (``partition_waves``); each wave's windows are gathered and convolved
    by ONE conv, and the waves of a partial-sum chain accumulate in order
    (``_wave_executor``).
  * ``mode="megakernel"``: each conv node is ONE launch of the
    wave-replay kernel (K1 at fp32, K3 at int8, kernels/wave_replay and
    kernels/wave_replay_q) over a ``KernelProgram`` re-planned at the
    kernel's budget point (``graph_kernel_programs``).
  * ``mode="graphkernel"``: the conv schedule partitioned into fused
    chains (``graph_chain_programs``), each multi-node chain ONE launch of
    the whole-chain kernel (K2 at fp32, K4 at int8); a single-node chain
    takes the per-layer launch.

In the scan and wave executors the per-step conv is pluggable: the
direct conv (``conv_backend="xla"``, the name the reference gives its
XLA conv) or the streaming conv kernel K6 (``conv_backend="pallas"``,
kernels/conv_stream), or any ``conv_fn``. Steps that convolve several
conv groups at once (a scan step with ``gcount > 1``, a wave dispatch
with ``dispatch_groups > 1``) run the direct grouped conv, as the
reference runs them outside its kernel. In the graph forward,
``pool_backend="fused"`` runs every pooled, ReLU'd conv through the
fused conv + ReLU + pool kernel K5 (kernels/fused_conv_pool).

Residual adds fold into the producing conv's kernel epilogue in the
megakernel modes (``residual_fusion``) and run as explicit elementwise
adds in the others. Activations are dropped per the graph's liveness
plan the moment their last consumer has fired. The layer-level and
graph-level entry points share one executor cache
(``_call_cached``), keyed as the reference keys its executables.

``conv2d_direct`` / ``maxpool_direct`` / ``run_graph_reference`` are the
direct (undecomposed) reference: NHWC activations and HWIO weights at
the boundary, ``F.conv2d`` (always with TF32 off) inside.
"""
from __future__ import annotations

import functools
import itertools
import weakref
from collections import OrderedDict
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.decomposition import (ConvLayer, Plan, evaluate,
                                            plan_decomposition, tile_grid)
from repro_torch.core.graph import (INPUT, NetworkGraph, check_graph_input,
                                    conv_keyed, fusible_chains, plan_buffers,
                                    residual_fusion, topological_schedule)
from repro_torch.core.schedule import (DEFAULT_VMEM_BUDGET as _VMEM_DEFAULT,
                                       ChainNodeSpec, KernelProgram,
                                       TileProgram, WaveProgram,
                                       chain_vmem_bytes, compile_layer,
                                       lower_graph_kernel,
                                       lower_kernel_program, partition_waves)
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.runtime.errors import PlanError

MODES = ("megakernel", "graphkernel", "wave", "scan", "interpret")


def _normalize_mode(mode: str) -> str:
    """One executor vocabulary across layer- and graph-level APIs:
    ``jit`` and ``scan`` name the same serial step replay."""
    if mode in ("jit", "scan"):
        return "scan"
    if mode in MODES:
        return mode
    raise ValueError(f"unknown executor mode {mode!r} (expected "
                     f"graphkernel | megakernel | wave | scan/jit | "
                     f"interpret)")


def check_mode(mode: str, precision: str = "fp32") -> str:
    """Raise for an executor mode or precision this package cannot run;
    returns the normalized mode. int8 runs in the megakernel modes only,
    as in the reference."""
    if precision not in ("fp32", "int8"):
        raise ValueError(f"unknown precision {precision!r} "
                         f"(expected fp32 | int8)")
    mode = _normalize_mode(mode)
    if precision == "int8" and mode not in ("megakernel", "graphkernel"):
        raise ValueError(
            "precision='int8' runs on the quantized megakernel only: "
            "pass mode='megakernel' or mode='graphkernel'")
    return mode


def _cudnn_fp32():
    """cuDNN with TF32 off and every other flag as it stands: an fp32
    convolution in fp32, whatever the process's default."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=False)


def conv2d_direct(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  pad: int = 0, groups: int = 1) -> torch.Tensor:
    """x (B,H,W,Cin), w (K,K,Cin/groups,Cout) -> (B,Ho,Wo,Cout), fp32
    arithmetic (cuDNN's TF32 is off for the call)."""
    with _cudnn_fp32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=stride, padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1)


def maxpool_direct(x: torch.Tensor, window: int,
                   stride: int = 0) -> torch.Tensor:
    """VALID max-pool over (B,H,W,C)."""
    stride = stride or window
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Pluggable tile-conv backends
# ---------------------------------------------------------------------------

def xla_tile_conv_fn(stride: int) -> Callable:
    """Default backend: one direct VALID conv per (halo-inclusive) tile."""
    return lambda xt, wt: conv2d_direct(xt, wt, stride, 0)


def pallas_tile_conv_fn(stride: int, row_block: int = 8) -> Callable:
    """Streaming-kernel backend (K6, kernels/conv_stream).

    The executor hands over tiles that already carry their stride-aware
    halo (``ih = (oh-1)*stride + K``), exactly the pre-padded VALID input
    ``conv2d_stream_raw`` wants, and its ``H_out`` recomputed from the
    tile equals the planner's ``oh``: no coordinate fix-up is needed.
    On CUDA tensors every call is one launch of the kernel; on CPU
    tensors its plain version runs.
    """
    from repro_torch.kernels.conv_stream.kernel import conv2d_stream_raw

    def fn(xt, wt):
        rb = min(row_block, (xt.shape[1] - wt.shape[0]) // stride + 1)
        return conv2d_stream_raw(xt, wt, stride=stride, row_block=rb)
    return fn


# Stable identities for custom conv_fn callables: id() can be recycled
# after a collected callable, which would silently serve an executor
# built for the *wrong* conv function. Tokens from a monotonic counter
# held in a WeakKeyDictionary are never reused, and die with the callable.
_CONV_FN_TOKENS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_TOKEN_COUNTER = itertools.count()


def _conv_fn_token(fn: Callable) -> str:
    try:
        tok = _CONV_FN_TOKENS.get(fn)
        if tok is None:
            tok = f"custom:{next(_TOKEN_COUNTER)}"
            _CONV_FN_TOKENS[fn] = tok
        return tok
    except TypeError:
        # unhashable / non-weakrefable callable: a unique token per call,
        # so it always rebuilds and never aliases
        return f"custom-uncacheable:{next(_TOKEN_COUNTER)}"


def _resolve_conv_fn(conv_fn, conv_backend, stride,
                     conv_fn_name: Optional[str] = None):
    """Pick the tile-conv callable and a *stable* cache key for it.

    A caller-supplied ``conv_fn_name`` keys the executor cache directly
    (the caller asserts two same-named callables compute the same);
    otherwise custom callables get a weakref-backed token that is never
    recycled.
    """
    if conv_fn is not None:
        return conv_fn, (f"named:{conv_fn_name}" if conv_fn_name
                         else _conv_fn_token(conv_fn))
    if conv_backend == "pallas":
        return pallas_tile_conv_fn(stride), "pallas"
    return xla_tile_conv_fn(stride), "xla"


# both lowerings are pure on hashable frozen inputs; memoizing them means
# the forward builder, its operand tables and the re-planner share one
# lowering + validation per program
_partition_waves_cached = functools.lru_cache(maxsize=128)(partition_waves)
_lower_kernel_cached = functools.lru_cache(maxsize=128)(lower_kernel_program)


def _rows(table) -> list:
    """An operand table (numpy array, tensor or nested sequence) as
    nested Python lists: the executors slice by its values on the host."""
    return table.tolist() if hasattr(table, "tolist") else list(table)


# ---------------------------------------------------------------------------
# Interpreted executor (the original Python walk, kept as reference)
# ---------------------------------------------------------------------------

def run_layer_interpreted(layer: ConvLayer, plan: Plan, x: torch.Tensor,
                          w: torch.Tensor, b: Optional[torch.Tensor] = None,
                          conv_fn: Optional[Callable] = None
                          ) -> torch.Tensor:
    """Execute one CONV layer via the planned tile schedule, in Python.

    x: (B, in_h, in_w, in_c); w: (K, K, in_c/groups, out_c). Returns the
    full (B, out_h, out_w, out_c) output, assembled tile by tile."""
    l = layer
    if tuple(x.shape[1:]) != (l.in_h, l.in_w, l.in_c):
        raise ValueError(
            f"{l.name}: input {tuple(x.shape[1:])} != declared "
            f"({l.in_h}, {l.in_w}, {l.in_c})")
    conv_fn = conv_fn or xla_tile_conv_fn(l.stride)
    B = x.shape[0]
    xp = F.pad(x, (0, 0, l.pad, l.pad, l.pad, l.pad))
    out = x.new_zeros((B, l.out_h, l.out_w, l.out_c))

    cg = -(-l.in_c // plan.in_splits)
    fg = -(-l.out_c // plan.feat_splits)
    out_per_group = l.out_c // l.groups
    in_per_group = l.in_c // l.groups
    gcount = l.groups if (l.groups > 1 and plan.feat_splits == 1) else 1
    for t in tile_grid(l, plan):
        xin_full = xp[:, t["iy"]:t["iy"] + t["ih"],
                      t["ix"]:t["ix"] + t["iw"], :]
        for f in range(plan.feat_splits):
            f0, f1 = f * fg, min((f + 1) * fg, l.out_c)
            if f0 >= l.out_c:
                continue
            acc = torch.zeros((B, t["oh"], t["ow"], f1 - f0),
                              dtype=torch.float32, device=x.device)
            for c in range(plan.in_splits):
                if l.groups == 1:
                    c0, c1 = c * cg, min((c + 1) * cg, l.in_c)
                elif plan.feat_splits > 1:
                    # the feature group lies inside one conv group (the
                    # planner aligns them): read only that group's inputs
                    g = f0 // out_per_group
                    c0, c1 = g * in_per_group, (g + 1) * in_per_group
                else:
                    c0, c1 = 0, l.in_c
                if c0 >= l.in_c:
                    continue
                wt = w[:, :, :, f0:f1] if l.groups > 1 else \
                    w[:, :, c0:c1, f0:f1]
                if gcount > 1:
                    part = conv2d_direct(xin_full[..., c0:c1], wt, l.stride,
                                         0, groups=gcount)
                else:
                    part = conv_fn(xin_full[..., c0:c1], wt)
                acc = acc + part.float()        # the on-chip psum (fp32)
            if b is not None:
                acc = acc + b[f0:f1].float()
            out[:, t["oy"]:t["oy"] + t["oh"],
                t["ox"]:t["ox"] + t["ow"], f0:f1] = acc.to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# Scan executor: replay the TileProgram's step table in a Python loop
# ---------------------------------------------------------------------------

def _pad_to_grid(g: TileProgram, x: torch.Tensor, w: torch.Tensor):
    """Pad input/weights up to the program's uniform tile grid.

    When the conv window never reaches the last input rows/cols
    ((in - K) % stride != 0), pad_h/pad_w is *smaller* than the
    conv-padded input, hence the trailing trim."""
    l = g.layer
    xp = F.pad(x, (0, g.in_c_pad - l.in_c,
                   l.pad, max(0, g.pad_w - l.in_w - l.pad),
                   l.pad, max(0, g.pad_h - l.in_h - l.pad)))
    wp = F.pad(w, (0, g.out_c_pad - l.out_c, 0, g.w_in_pad - w.shape[2]))
    return xp[:, :g.pad_h, :g.pad_w], wp


def _traced_execute(kind: str, layer_of: Callable):
    """Wrap an executor body in a ``cat="execute"`` span. The port runs
    eagerly, so the span fires once per executor call (the reference's
    fire once per jit trace). The disabled path is one global read: no
    span objects, no context manager."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(prog, *a, **k):
            t = _trace.current_tracer()
            if t is None:
                return fn(prog, *a, **k)
            name = layer_of(prog).name
            with t.span(f"{kind}:{name}", cat="execute", node=name,
                        kind=kind):
                return fn(prog, *a, **k)
        return wrapper
    return deco


@_traced_execute("scan", lambda p: p.layer)
def _scan_executor(program: TileProgram, conv_fn: Callable, has_bias: bool,
                   x, w, b, ops):
    """Replay ``program``'s (n_steps, 7) step table ``ops`` in order: one
    conv per step (``conv_fn``, or the direct grouped conv when a step
    convolves ``gcount > 1`` groups) added into an fp32 output buffer."""
    g, l = program, program.layer
    B = x.shape[0]
    xp, wp = _pad_to_grid(g, x, w)
    out = torch.zeros((B, g.out_h_pad, g.out_w_pad, g.out_c_pad),
                      dtype=torch.float32, device=x.device)
    for iy, ix, oy, ox, c0, wc0, f0 in _rows(ops):
        xt = xp[:, iy:iy + g.ih, ix:ix + g.iw, c0:c0 + g.cg]
        wt = wp[:, :, wc0:wc0 + g.fan, f0:f0 + g.fg]
        if g.gcount > 1:
            part = conv2d_direct(xt, wt, l.stride, 0, groups=g.gcount)
        else:
            part = conv_fn(xt, wt)
        out[:, oy:oy + g.oh, ox:ox + g.ow, f0:f0 + g.fg] += part.float()
    out = out[:, :l.out_h, :l.out_w, :l.out_c]
    if has_bias:
        out = out + b.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Wave executor: one conv per dependency-free wave
# ---------------------------------------------------------------------------

@_traced_execute("wave", lambda p: p.program.layer)
def _wave_executor(wprog: WaveProgram, conv_fn: Callable, has_bias: bool,
                   x, w, b, wave_ops):
    """Replay a WaveProgram: ONE conv per wave.

    Per wave, every tile's halo-inclusive input window is gathered and
    stacked along the batch axis; the wave's feature groups all read the
    same input-channel group, so they collapse into the conv's
    output-channel width, and the whole wave is one ``(n_tiles * B, ih,
    iw, c)`` conv over the wave's weight slice (the direct grouped conv
    when ``dispatch_groups > 1``). The stacked results reassemble into the
    padded output by a static transpose, since the wave's blocks are the
    raster tiling of the padded output.

    Waves accumulate in chain order onto a zero fp32 buffer. Multi-wave
    chains gather each tile window once at full channel width (tile
    windows are the same in every wave; only the channel offset walks
    along a chain), and each wave takes its channel slice of that stack.
    """
    g = wprog.program
    l, plan = g.layer, g.plan
    B = x.shape[0]
    T = wprog.n_tiles
    xp, wp = _pad_to_grid(g, x, w)
    if wprog.dispatch_groups > 1:
        def conv(xt, wt):
            return conv2d_direct(xt, wt, l.stride, 0,
                                 groups=wprog.dispatch_groups)
    else:
        conv = conv_fn

    def conv_wave(wins, wc0):
        # wins (T, B, ih, iw, c_width); wc0 the wave's weight fan offset
        wt = wp[:, :, wc0:wc0 + wprog.fan_width, :]
        part = conv(wins.reshape(T * B, g.ih, g.iw, wprog.c_width), wt)
        img = part.float().reshape(plan.tiles_h, plan.tiles_w, B, g.oh,
                                   g.ow, g.out_c_pad)
        return img.permute(2, 0, 3, 1, 4, 5).reshape(
            B, g.out_h_pad, g.out_w_pad, g.out_c_pad)

    def gather(tiles, c0, width):
        # tiles: the wave's rows [iy, ix, oy, ox, c0, wc0]
        return torch.stack([xp[:, r[0]:r[0] + g.ih, r[1]:r[1] + g.iw,
                               c0:c0 + width] for r in tiles])

    waves = _rows(wave_ops)
    out = torch.zeros((B, g.out_h_pad, g.out_w_pad, g.out_c_pad),
                      dtype=torch.float32, device=x.device)
    if wprog.n_waves == 1:
        tiles = waves[0]
        out += conv_wave(gather(tiles, tiles[0][4], wprog.c_width),
                         tiles[0][5])
    else:
        # gather once per unique window (full channel width), then walk
        # the chain: each wave slices its channel group from the stack
        wins_all = gather(waves[0], 0, g.in_c_pad)
        for tiles in waves:
            c0 = tiles[0][4]
            out += conv_wave(wins_all[..., c0:c0 + wprog.c_width],
                             tiles[0][5])
    out = out[:, :l.out_h, :l.out_w, :l.out_c]
    if has_bias:
        out = out + b.float()
    return out.to(x.dtype)


def run_layer_wave(wprog: WaveProgram, x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None,
                   conv_fn: Optional[Callable] = None,
                   conv_backend: str = "xla",
                   conv_fn_name: Optional[str] = None) -> torch.Tensor:
    """Execute a pre-partitioned WaveProgram under the wave executor."""
    l = wprog.program.layer
    _check_input(l, x)
    conv_fn, conv_key = _resolve_conv_fn(conv_fn, conv_backend, l.stride,
                                         conv_fn_name)
    key = (wprog.geometry, "wave", conv_key, "fp32", b is not None,
           x.shape[0], str(x.dtype))
    return _call_cached(key, lambda: functools.partial(
        _wave_executor, wprog, conv_fn, b is not None),
        x, w, b, wprog.tile_operands())


# ---------------------------------------------------------------------------
# The executor cache: one built executor per (schedule geometry, mode,
# conv backend, precision, bias, batch, dtype), as the reference keys its
# jitted executables. The operand table is an argument of every call, so
# replays with the same geometry hit the cache. LRU-bounded: a long-lived
# server cycling through many geometries or custom conv_fns evicts the
# coldest entry instead of growing without bound. Its counters go to the
# metrics registry (``executor_cache.{hits,misses,evictions,poisoned}``).
# ---------------------------------------------------------------------------

_EXECUTOR_CACHE: "OrderedDict[tuple, Callable]" = OrderedDict()
_EXECUTOR_CACHE_LIMIT = 64


def clear_executor_cache() -> None:
    """Drop every cached executor (tests; long-lived server hygiene)."""
    _EXECUTOR_CACHE.clear()


def executor_cache_size() -> int:
    return len(_EXECUTOR_CACHE)


def set_executor_cache_limit(limit: int) -> None:
    """Bound the executor cache; evicts least-recently-used over it."""
    global _EXECUTOR_CACHE_LIMIT
    if limit < 1:
        raise ValueError("executor cache limit must be >= 1")
    _EXECUTOR_CACHE_LIMIT = limit
    while len(_EXECUTOR_CACHE) > _EXECUTOR_CACHE_LIMIT:
        _EXECUTOR_CACHE.popitem(last=False)
        _metrics.registry().counter("executor_cache.evictions").inc()


def _cached_executable(key: tuple, build: Callable) -> Callable:
    reg = _metrics.registry()
    fn = _EXECUTOR_CACHE.get(key)
    if fn is None:
        reg.counter("executor_cache.misses").inc()
        fn = _EXECUTOR_CACHE[key] = build()
    else:
        reg.counter("executor_cache.hits").inc()
        _EXECUTOR_CACHE.move_to_end(key)
    while len(_EXECUTOR_CACHE) > _EXECUTOR_CACHE_LIMIT:
        _EXECUTOR_CACHE.popitem(last=False)
        reg.counter("executor_cache.evictions").inc()
    return fn


def _call_cached(key: tuple, build: Callable, *args):
    """Get-or-build the executor for ``key`` and invoke it.

    A failing call evicts the entry (``executor_cache.poisoned``): the
    cache only holds executors whose most recent call succeeded, so a
    retry starts from a clean slot. A failing ``build`` inserts nothing.
    The first call of a fresh entry runs under a ``compile`` span, later
    ones under ``executor_call``, as in the reference."""
    fresh = key not in _EXECUTOR_CACHE
    fn = _cached_executable(key, build)
    try:
        if _trace.current_tracer() is None:     # disabled fast path
            return fn(*args)
        if fresh:
            with _trace.span("compile", cat="compile"):
                return fn(*args)
        with _trace.span("executor_call", cat="run"):
            return fn(*args)
    except Exception:
        _EXECUTOR_CACHE.pop(key, None)
        _metrics.registry().counter("executor_cache.poisoned").inc()
        raise


def _check_input(l: ConvLayer, x: torch.Tensor) -> None:
    if tuple(x.shape[1:]) != (l.in_h, l.in_w, l.in_c):
        raise ValueError(
            f"{l.name}: input {tuple(x.shape[1:])} != declared "
            f"({l.in_h}, {l.in_w}, {l.in_c}) — schedule offsets would "
            f"silently address the wrong pixels")


def run_layer_scheduled(program: TileProgram, x: torch.Tensor,
                        w: torch.Tensor, b: Optional[torch.Tensor] = None,
                        conv_fn: Optional[Callable] = None,
                        conv_backend: str = "xla",
                        conv_fn_name: Optional[str] = None) -> torch.Tensor:
    """Execute a pre-lowered TileProgram under the scan executor.

    A custom ``conv_fn`` caches by a stable weakref-backed token (or by
    ``conv_fn_name`` when given): pass a *stable* callable or a name, not
    a fresh per-call lambda, or every call builds a new entry. The named
    ``conv_backend`` strings cache by name."""
    l = program.layer
    _check_input(l, x)
    conv_fn, conv_key = _resolve_conv_fn(conv_fn, conv_backend, l.stride,
                                         conv_fn_name)
    key = (program.geometry, "scan", conv_key, "fp32", b is not None,
           x.shape[0], str(x.dtype))
    return _call_cached(key, lambda: functools.partial(
        _scan_executor, program, conv_fn, b is not None),
        x, w, b, program.operands())


def run_layer_streamed(layer: ConvLayer, plan: Plan, x: torch.Tensor,
                       w: torch.Tensor, b: Optional[torch.Tensor] = None,
                       conv_fn: Optional[Callable] = None,
                       mode: str = "wave", conv_backend: str = "xla",
                       conv_fn_name: Optional[str] = None,
                       precision: str = "fp32",
                       quant=None) -> torch.Tensor:
    """Execute one CONV layer via the planned tile schedule.

    ``mode="wave"`` (default) runs each dependency-free wave as one conv;
    ``mode="jit"`` (alias ``"scan"``) replays the step table;
    ``mode="interpret"`` runs the per-tile Python loop. The layer-level
    megakernel entry points (``mode="megakernel"``/``"graphkernel"``, and
    ``precision="int8"``) are not ported yet and raise
    ``NotImplementedError``; the graph path serves those modes.
    """
    mode = check_mode(mode, precision)
    if precision == "int8":
        raise NotImplementedError(
            "run_layer_streamed(precision='int8') is not ported yet: "
            "ROADMAP queue 1 item 5 (run_layer_megakernel_q); the graph "
            "path serves int8 (StreamingSession(precision='int8'))")
    if mode in ("megakernel", "graphkernel"):
        raise NotImplementedError(
            f"run_layer_streamed(mode={mode!r}) is not ported yet: ROADMAP "
            f"queue 1 item 3 (run_layer_megakernel); the graph path serves "
            f"it (StreamingSession(mode={mode!r}))")
    if mode == "interpret":
        return run_layer_interpreted(layer, plan, x, w, b, conv_fn)
    if mode == "wave":
        wprog = _partition_waves_cached(compile_layer(layer, plan))
        return run_layer_wave(wprog, x, w, b, conv_fn=conv_fn,
                              conv_backend=conv_backend,
                              conv_fn_name=conv_fn_name)
    return run_layer_scheduled(compile_layer(layer, plan), x, w, b,
                               conv_fn=conv_fn, conv_backend=conv_backend,
                               conv_fn_name=conv_fn_name)


def plan_graph(graph: NetworkGraph,
               sram_budget: int = 128 * 1024) -> "OrderedDict[str, Plan]":
    """Plan every conv node's decomposition under one buffer budget."""
    return OrderedDict((n.name, plan_decomposition(n.layer, sram_budget))
                       for n in graph.conv_nodes())


def compile_graph(graph: NetworkGraph,
                  plans) -> "OrderedDict[str, TileProgram]":
    """Lower every conv node's Plan to its TileProgram, keyed by node."""
    plans = conv_keyed(graph, plans, "plans")
    return OrderedDict((name, compile_layer(graph.node(name).layer, p))
                       for name, p in plans.items())


def _graph_epilogues(graph: NetworkGraph):
    """Per conv node: (epilogue_relu, residual_value | None, out_value).

    Residual-fused convs take the add's ReLU as their epilogue ReLU and
    produce the ADD's value (the add node itself is skipped); all other
    convs keep their own flags.
    """
    rf = residual_fusion(graph)
    conv_res = rf.conv_residual()
    add_of = rf.add_of_conv()
    by_name = {n.name: n for n in graph.nodes}
    out = {}
    for n in graph.conv_nodes():
        if n.name in conv_res:
            add = by_name[add_of[n.name]]
            out[n.name] = (add.relu, conv_res[n.name], add.name)
        else:
            out[n.name] = (n.relu, None, n.name)
    return out


def _graph_kernel_program(program: TileProgram, relu: bool,
                          residual: bool,
                          vmem_budget: Optional[int],
                          batch: int = 1) -> KernelProgram:
    """Megakernel lowering for one graph conv node: the node's ReLU (or
    its fused add's) in the epilogue, the layer's pool fused when it has
    one, the residual operand when an add folds in, and the schedule
    re-planned at the kernel's budget point (``plan_for_vmem``; ``None``
    replays the given program 1:1)."""
    l = program.layer
    fuse = l.pool > 1
    if vmem_budget is None:
        return _lower_kernel_cached(_partition_waves_cached(program),
                                    relu=relu, fuse_pool=fuse,
                                    residual=residual, vmem_budget=None,
                                    batch_block=batch)
    plan = plan_for_vmem(l, vmem_budget, fuse, residual=residual,
                         batch=batch)
    return _lower_kernel_cached(
        _partition_waves_cached(compile_layer(l, plan)),
        relu=relu, fuse_pool=fuse, residual=residual,
        vmem_budget=vmem_budget, batch_block=batch)


def graph_kernel_programs(
        graph: NetworkGraph, programs,
        vmem_budget: Optional[int] = _VMEM_DEFAULT,
        batch: int = 1) -> "OrderedDict[str, KernelProgram]":
    """The megakernel lowering of a whole graph, exactly as the graph
    forward replays it (per-node epilogue ReLU, fused pools, residual
    operands, budget re-planning)."""
    programs = conv_keyed(graph, programs, "programs")
    epi = _graph_epilogues(graph)
    return OrderedDict(
        (name, _graph_kernel_program(p, epi[name][0],
                                     epi[name][1] is not None,
                                     vmem_budget, batch))
        for name, p in programs.items())


def graph_chain_programs(graph: NetworkGraph, programs,
                         vmem_budget: Optional[int] = _VMEM_DEFAULT,
                         quantized: bool = False,
                         batch: int = 1):
    """Partition a graph into fused chains and lower each multi-node
    chain to its whole-chain ``GraphKernelProgram``.

    Returns ``(chains, kprogs, gkps)``: the ``FusedChain`` partition in
    schedule order, the per-node ``KernelProgram`` map (single-node
    chains fall back to these per-layer launches), and the
    ``GraphKernelProgram`` per multi-node chain keyed by its HEAD conv
    name. Deterministic for a (graph, programs, budget, precision,
    batch) tuple, so operand tables and the forward derive the
    identical partition independently.

    Chain membership is decided at the per-image footprint (a chain
    valid at one image per step stays fusible at any batch); each
    chain is lowered with the largest per-step image block whose
    whole-chain arena and accumulator fit the budget, as the reference
    lowers it.
    """
    programs = conv_keyed(graph, programs, "programs")
    kprogs = graph_kernel_programs(graph, programs, vmem_budget, batch)
    chains = fusible_chains(graph, kprogs, vmem_budget=vmem_budget,
                            quantized=quantized)
    epi = _graph_epilogues(graph)
    by_name = {n.name: n for n in graph.nodes}
    gkps = {}
    for c in chains:
        if len(c.convs) < 2:
            continue
        specs = [ChainNodeSpec(name=name, kp=kprogs[name],
                               in_value=by_name[name].inputs[0],
                               out_value=epi[name][2],
                               residual_value=epi[name][1])
                 for name in c.convs]
        gkps[c.convs[0]] = lower_graph_kernel(
            specs, quantized=quantized,
            batch_block=_chain_batch_block(specs, quantized, vmem_budget,
                                           batch))
    return chains, kprogs, gkps


def _chain_batch_block(specs, quantized: bool,
                       vmem_budget: Optional[int], batch: int) -> int:
    """Largest images-per-step block whose whole-chain footprint (arena
    slots + accumulator + input/output blocks, all per image) fits
    ``vmem_budget``. ``chain_vmem_bytes`` is affine in the block size
    (weights and bias are batch-shared), so the bound solves in two
    evaluations. ``None`` budget takes the full batch."""
    bb = max(1, int(batch))
    if vmem_budget is None or bb == 1:
        return bb
    b1 = chain_vmem_bytes(specs, quantized=quantized, batch_block=1)
    per = chain_vmem_bytes(specs, quantized=quantized, batch_block=2) - b1
    if per <= 0:
        return bb
    fit = (vmem_budget - (b1 - per)) // per
    return max(1, min(bb, int(fit)))


def graph_operands(graph: NetworkGraph, programs,
                   mode: str = "megakernel",
                   vmem_budget: Optional[int] = _VMEM_DEFAULT,
                   precision: str = "fp32", batch: int = 1,
                   device="cuda") -> "OrderedDict[str, torch.Tensor]":
    """Operand tables matching ``graph_forward_fn``, keyed by node (or
    chain head) name. Megakernel mode: per conv node the ``(n_chain,
    n_tiles, 8)`` int32 table on ``device``; graphkernel mode: one table
    per fused chain, keyed by its head conv, ``(total_steps, 14)`` for a
    multi-node chain and the per-layer table for a single-node one, on
    ``device``. Wave mode: the ``(n_waves, n_tiles, 6)`` dispatch table
    per conv node; scan mode: the ``(n_steps, 7)`` step table. The wave
    and scan tables stay on the host, whatever ``device``: those executors
    slice by their values in Python. Pass the same ``batch`` as the
    forward builder."""
    mode = check_mode(mode, precision)
    if mode == "interpret":
        raise ValueError("interpret mode has no operand tables")
    programs = conv_keyed(graph, programs, "programs")
    if mode == "graphkernel":
        chains, kprogs, gkps = graph_chain_programs(
            graph, programs, vmem_budget,
            quantized=precision == "int8", batch=batch)
        return OrderedDict(
            (c.convs[0], torch.as_tensor(
                gkps[c.convs[0]].operand_table() if c.convs[0] in gkps
                else kprogs[c.convs[0]].operand_table(), device=device))
            for c in chains)
    if mode == "megakernel":
        return OrderedDict(
            (name, torch.as_tensor(kp.operand_table(), device=device))
            for name, kp in graph_kernel_programs(
                graph, programs, vmem_budget, batch).items())
    if mode == "wave":
        return OrderedDict(
            (name, torch.as_tensor(
                _partition_waves_cached(p).tile_operands()))
            for name, p in programs.items())
    return OrderedDict((name, torch.as_tensor(p.operands()))
                       for name, p in programs.items())


def graph_forward_fn(graph: NetworkGraph, programs,
                     mode: str = "megakernel",
                     vmem_budget: Optional[int] = _VMEM_DEFAULT,
                     precision: str = "fp32", qgraph=None,
                     dequantize: bool = True,
                     batch: int = 1, *,
                     conv_fn: Optional[Callable] = None,
                     conv_backend: str = "xla",
                     pool_backend: str = "xla") -> Callable:
    """Whole-graph forward over pre-lowered programs.

    Returns ``f(x, weights, ops) -> y`` where ``weights`` maps conv node
    name -> (w, b) and ``ops`` maps node (or chain head) name -> operand
    table (``graph_operands``). In megakernel mode each conv node is one
    wave-replay launch; in graphkernel mode each multi-node fused chain
    is one whole-chain launch at its head and its other nodes are
    skipped, while a single-node chain takes the per-layer launch.
    Residual adds fold into the producing conv's epilogue where
    ``residual_fusion`` allows, and run as explicit adds elsewhere.

    ``precision="int8"`` walks the same schedule and replays the same
    tables on the fixed-point datapath (kernels K3 and K4) over a
    calibrated ``qgraph`` (``quant.calibrate.QuantizedGraph``):
    ``weights`` are ``qgraph.device_weights(device)``, a float input is
    quantized at the input's scale (an int8 one is taken as codes), raw
    int8 flows along every edge, and residual adds are int32 adds with a
    clip. ``dequantize=False`` returns the raw int8 output.

    In wave and scan mode (fp32) every conv node runs the layer executor
    over its TileProgram, with ``conv_fn`` / ``conv_backend`` as the
    per-step conv, then its ReLU and pool as explicit ops; residual adds
    are explicit elementwise adds. ``pool_backend="fused"`` instead runs
    each pooled, ReLU'd conv node through the fused conv + ReLU + pool
    kernel (K5), one launch per node. ``pool_backend`` is ignored in the
    megakernel modes, whose kernels fuse the pool themselves.
    """
    mode = check_mode(mode, precision)
    if mode == "interpret":
        raise ValueError("the compiled graph path has no interpret mode: "
                         "use run_graph_streamed(mode='interpret')")
    if pool_backend not in ("xla", "fused"):
        raise ValueError(f"unknown pool backend {pool_backend!r} "
                         f"(expected xla | fused)")
    programs = conv_keyed(graph, programs, "programs")
    sched = topological_schedule(graph)
    bplan = plan_buffers(graph)
    if mode in ("wave", "scan"):
        return _layer_forward(graph, programs, sched, bplan, mode, conv_fn,
                              conv_backend, pool_backend)
    epi = _graph_epilogues(graph)
    if mode == "graphkernel":
        chains, kprogs, gkps = graph_chain_programs(
            graph, programs, vmem_budget, quantized=precision == "int8",
            batch=batch)
        chain_of = {c.convs[0]: c for c in chains}
        members = {name for c in chains for name in c.convs[1:]}
    else:
        kprogs = graph_kernel_programs(graph, programs, vmem_budget, batch)
        chain_of, members, gkps = {}, set(), {}
    fused_adds = {outv for _, resv, outv in epi.values() if resv is not None}

    if precision == "int8":
        if qgraph is None:
            raise ValueError(
                "precision='int8' needs a calibrated QuantizedGraph: run "
                "repro_torch.quant.calibrate.calibrate_graph first")
        from repro_torch.core.quantization import (dequantize_int8,
                                                   quantize_int8_sym)
        from repro_torch.kernels.wave_replay_q.graph import \
            wave_replay_graph_q
        from repro_torch.kernels.wave_replay_q.kernel import \
            residual_add_i8
        from repro_torch.kernels.wave_replay_q.ops import \
            wave_replay_q_layer
        statics = {name: (qgraph.quants[name].pre_shift,
                          qgraph.quants[name].fan_chunk)
                   for name in kprogs}
        in_scale = float(qgraph.scales[INPUT])
        out_scale = float(qgraph.scales[graph.output])

        def forward_q(x, weights, ops):
            check_graph_input(graph, x)
            env = {INPUT: x if x.dtype == torch.int8
                   else quantize_int8_sym(x, in_scale)}
            for i, n in enumerate(sched):
                if n.op == "conv":
                    if n.name in members:
                        pass                # ran inside its chain's launch
                    elif n.name in gkps:    # a multi-node fused chain
                        c = chain_of[n.name]
                        env[c.output_value] = wave_replay_graph_q(
                            gkps[n.name], env[c.input_value],
                            [weights[m] for m in c.convs],
                            pre_shifts=[statics[m][0] for m in c.convs],
                            fan_chunks=[statics[m][1] for m in c.convs],
                            table=ops[n.name])
                    else:
                        _, resv, outv = epi[n.name]
                        wq, bq, m, s = weights[n.name]
                        ps, fc = statics[n.name]
                        env[outv] = wave_replay_q_layer(
                            kprogs[n.name], env[n.inputs[0]], wq, bq, m, s,
                            pre_shift=ps, fan_chunk=fc, table=ops[n.name],
                            residual=env[resv] if resv is not None
                            else None)
                elif n.name not in fused_adds:
                    env[n.name] = residual_add_i8(
                        env[n.inputs[0]], env[n.inputs[1]], n.relu)
                for v in bplan.frees[i]:        # liveness: drop dead refs
                    env.pop(v, None)
            y = env[graph.output]
            return dequantize_int8(y, out_scale) if dequantize else y

        return forward_q

    from repro_torch.kernels.wave_replay.graph import wave_replay_graph
    from repro_torch.kernels.wave_replay.ops import wave_replay_layer

    def forward_mega(x, weights, ops):
        check_graph_input(graph, x)
        env = {INPUT: x}
        for i, n in enumerate(sched):
            if n.op == "conv":
                if n.name in members:
                    pass                    # ran inside its chain's launch
                elif n.name in gkps:        # a multi-node fused chain
                    c = chain_of[n.name]
                    env[c.output_value] = wave_replay_graph(
                        gkps[n.name], env[c.input_value],
                        [weights[m] for m in c.convs], table=ops[n.name])
                else:
                    _, resv, outv = epi[n.name]
                    w, b = weights[n.name]
                    env[outv] = wave_replay_layer(
                        kprogs[n.name], env[n.inputs[0]], w, b,
                        table=ops[n.name],
                        residual=env[resv] if resv is not None else None)
            elif n.name not in fused_adds:
                y = env[n.inputs[0]] + env[n.inputs[1]]
                env[n.name] = torch.relu(y) if n.relu else y
            for v in bplan.frees[i]:            # liveness: drop dead refs
                env.pop(v, None)
        return env[graph.output]

    return forward_mega


def _layer_forward(graph: NetworkGraph, programs, sched, bplan, mode: str,
                   conv_fn, conv_backend: str, pool_backend: str) -> Callable:
    """The wave/scan branch of ``graph_forward_fn``."""
    conv_fns = {name: _resolve_conv_fn(conv_fn, conv_backend,
                                       p.layer.stride)[0]
                for name, p in programs.items()}
    wprogs = {name: _partition_waves_cached(p) if mode == "wave" else None
              for name, p in programs.items()}
    if pool_backend == "fused":
        from repro_torch.kernels.fused_conv_pool.ops import fused_conv_pool

    def forward(x, weights, ops):
        check_graph_input(graph, x)
        env = {INPUT: x}
        for i, n in enumerate(sched):
            if n.op == "conv":
                l = n.layer
                xin = env[n.inputs[0]]
                w, b = weights[n.name]
                if pool_backend == "fused" and l.pool > 1 and n.relu:
                    env[n.name] = fused_conv_pool(
                        xin, w, b, stride=l.stride, pad=l.pad,
                        pool=l.pool, pool_stride=l.pool_stride or l.pool,
                        relu=True, groups=l.groups).to(x.dtype)
                else:
                    wprog = wprogs[n.name]
                    if wprog is not None:
                        y = _wave_executor(wprog, conv_fns[n.name],
                                           b is not None, xin, w, b,
                                           ops[n.name])
                    else:
                        y = _scan_executor(programs[n.name],
                                           conv_fns[n.name], b is not None,
                                           xin, w, b, ops[n.name])
                    if n.relu:
                        y = torch.relu(y)
                    if l.pool > 1:
                        y = maxpool_direct(y, l.pool,
                                           l.pool_stride or l.pool)
                    env[n.name] = y
            else:
                y = env[n.inputs[0]] + env[n.inputs[1]]
                env[n.name] = torch.relu(y) if n.relu else y
            for v in bplan.frees[i]:            # liveness: drop dead refs
                env.pop(v, None)
        return env[graph.output]

    return forward


def run_graph_reference(graph: NetworkGraph, weights,
                        x: torch.Tensor) -> "OrderedDict[str, torch.Tensor]":
    """Direct (undecomposed) reference forward over the graph schedule,
    returning EVERY value (``"input"`` included): each conv value is
    post-bias/ReLU/pool, each add value post-ReLU."""
    check_graph_input(graph, x)
    weights = conv_keyed(graph, weights, "weights")
    env = OrderedDict({INPUT: x})
    for n in topological_schedule(graph):
        if n.op == "conv":
            l = n.layer
            w, b = weights[n.name]
            y = conv2d_direct(env[n.inputs[0]], w.to(x.dtype),
                              l.stride, l.pad, groups=l.groups)
            if b is not None:
                y = y + b.to(x.dtype)
            if n.relu:
                y = torch.relu(y)
            if l.pool > 1:
                y = maxpool_direct(y, l.pool, l.pool_stride or l.pool)
        else:
            y = env[n.inputs[0]] + env[n.inputs[1]]
            if n.relu:
                y = torch.relu(y)
        env[n.name] = y
    return env


def run_graph_streamed(graph: NetworkGraph, plans, x: torch.Tensor,
                       weights, conv_fn: Optional[Callable] = None,
                       mode: str = "wave", conv_backend: str = "xla",
                       precision: str = "fp32", qgraph=None,
                       liveness: bool = True,
                       track_peak: Optional[list] = None) -> torch.Tensor:
    """Run a NetworkGraph end to end through the streaming executors.

    ``plans``/``weights`` map conv node name -> Plan / (w, b), or are
    sequences in schedule order. ``mode="interpret"`` walks the graph
    eagerly with the per-tile Python executor (adds as explicit
    elementwise ops); the other modes build one whole-graph forward with
    its operand tables (on ``x``'s device for the kernel modes), cached in
    the executor cache by the graph's **topology key** plus per-node
    schedule geometry, so two graphs sharing a layer geometry but wired
    differently never collide. ``precision="int8"`` (megakernel /
    graphkernel) needs a calibrated ``qgraph`` and ignores ``weights``.

    ``liveness=False`` disables the buffer-liveness pass on the eager walk
    (every activation held to the end). ``track_peak``, a list, receives
    the peak of summed live activation bytes across the eager walk
    (interpret mode only).
    """
    mode = _normalize_mode(mode)
    check_graph_input(graph, x)
    plans = conv_keyed(graph, plans, "plans")
    if precision != "int8":
        weights = conv_keyed(graph, weights, "weights")
    if mode == "interpret":
        if precision != "fp32":
            raise ValueError("interpret mode is fp32-only: the int8 "
                             "datapath runs on the megakernel")
        sched = topological_schedule(graph)
        bplan = plan_buffers(graph) if liveness else None

        def nbytes(t):
            return t.numel() * t.element_size()

        env = {INPUT: x}
        peak = nbytes(x)
        for i, n in enumerate(sched):
            if n.op == "conv":
                l = n.layer
                w, b = weights[n.name]
                y = run_layer_interpreted(l, plans[n.name],
                                          env[n.inputs[0]], w, b, conv_fn)
                if n.relu:
                    y = torch.relu(y)
                if l.pool > 1:
                    y = maxpool_direct(y, l.pool, l.pool_stride or l.pool)
                env[n.name] = y
            else:
                y = env[n.inputs[0]] + env[n.inputs[1]]
                env[n.name] = torch.relu(y) if n.relu else y
            peak = max(peak, sum(nbytes(v) for v in env.values()))
            if bplan is not None:
                for v in bplan.frees[i]:
                    env.pop(v, None)
        if track_peak is not None:
            track_peak.append(peak)
        return env[graph.output]

    check_mode(mode, precision)
    programs = compile_graph(graph, plans)
    conv_key = _resolve_conv_fn(
        conv_fn, conv_backend,
        next(iter(programs.values())).layer.stride)[1]
    # the int8 forward bakes the calibration statics in (entry/exit
    # scales, per-node pre_shift/fan_chunk), so they key the entry: a
    # recalibrated graph over the same geometry never reuses a stale one
    qsig = ()
    if precision == "int8":
        qsig = (float(qgraph.scales[INPUT]),
                float(qgraph.scales[graph.output]),
                tuple((name, q.pre_shift, q.fan_chunk)
                      for name, q in sorted(qgraph.quants.items())))
    B = x.shape[0]
    key = (graph.topology_key,
           tuple(p.geometry for p in programs.values()),
           mode, precision, conv_key, qsig, B, str(x.dtype), str(x.device))

    def build():
        fwd = graph_forward_fn(graph, programs, mode, precision=precision,
                               qgraph=qgraph, batch=B, conv_fn=conv_fn,
                               conv_backend=conv_backend)
        ops = graph_operands(graph, programs, mode, precision=precision,
                             batch=B, device=x.device)
        return lambda x, weights: fwd(x, weights, ops)

    if precision == "int8":
        return _call_cached(key, build, x, qgraph.device_weights(x.device))
    return _call_cached(key, build, x, weights)


@functools.lru_cache(maxsize=128)
def plan_for_vmem(layer: ConvLayer,
                  vmem_budget: int = _VMEM_DEFAULT,
                  fuse_pool: bool = False,
                  max_tiles: int = 8,
                  residual: bool = False,
                  batch: int = 1) -> Plan:
    """Re-plan a layer's decomposition at the megakernel's budget point.

    The fewest (tile x chain) grid steps whose fp32 working set
    (``KernelProgram.vmem_bytes``) fits, ties broken toward the smaller
    working set; when nothing fits, the over-budget candidate with the
    fewest steps wins. Feature splits stay at 1. ``batch`` scores the
    TOTAL grid steps for the whole batch — ``ceil(batch / batch_block) *
    tiles * chain``. The same search as the reference, so both packages
    replay the same programs.
    """
    best = None          # ((over_budget, grid_steps, ws), plan)
    in_choices = sorted({1, 2, 4, 8, 16, 32, 64, 128, layer.in_c})
    for th in range(1, max_tiles + 1):
        for tw in range(1, max_tiles + 1):
            for cs in in_choices:
                if cs > layer.in_c:
                    continue
                p = evaluate(layer, th, tw, 1, cs)
                if p is None:
                    continue
                kp = _lower_kernel_cached(
                    _partition_waves_cached(compile_layer(layer, p)),
                    relu=True, fuse_pool=fuse_pool, residual=residual,
                    vmem_budget=None if batch == 1 else vmem_budget,
                    batch_block=batch)
                ws = kp.vmem_bytes
                n_bb = -(-batch // kp.batch_block)
                key = (ws > vmem_budget,
                       n_bb * kp.n_tiles * kp.n_chain, ws)
                if best is None or key < best[0]:
                    best = (key, p)
    if best is None:
        raise PlanError(f"{layer.name}: no feasible megakernel plan")
    return best[1]
