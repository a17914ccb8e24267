"""Launcher of the streaming max-pool kernel K7 (``csrc/maxpool_stream.cu``).

``maxpool_stream_raw`` checks an NHWC input and on a CUDA tensor launches
the hand-written kernel once on the current stream; on a CPU tensor it
runs the plain version (``ref.maxpool_stream_plain``). There is no other
route: a tensor on any other device, or a launch the CUDA runtime refuses,
raises. ``row_block`` shapes the plain version's walk; the CUDA kernel
cuts the work its own way (``tiling``), which changes no output, since a
max is exact in any order.

``launches`` counts launches of the hand-written kernel, one where the
launch succeeds and nowhere else; ``plain_calls`` counts the plain
version's runs on CPU tensors, which launch nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.maxpool_stream.ref import (maxpool_stream_plain,
                                                    pooled_size)
from repro_torch.runtime.errors import KernelLaunchError

# Shared memory a CTA of csrc/maxpool_stream.cu may stage (the static
# 48 KB a launch gets without opting in), and its channel slice.
SMEM_BYTES = 48 * 1024
CHANNEL_SLICE = 32
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

launches = 0
plain_calls = 0


def launch_count() -> int:
    """Launches of the CUDA kernel since ``reset_launch_count``."""
    return launches


def plain_count() -> int:
    """Runs of the plain version on CPU tensors since
    ``reset_launch_count``."""
    return plain_calls


def reset_launch_count() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def tiling(h_out: int, w_out: int, c: int, pool: int, ps: int,
           row_block: int, esize: int) -> "tuple[int, int, int]":
    """(output rows, output columns, channels) of one CTA: the row block,
    all columns and a 32-channel slice, cut (rows first, then columns,
    then channels) until the input window they read fits ``SMEM_BYTES``.
    """
    rows, cols, cs = min(row_block, h_out), w_out, min(c, CHANNEL_SLICE)

    def smem(r, w, s):
        return ((r - 1) * ps + pool) * ((w - 1) * ps + pool) * s * esize

    while smem(rows, cols, cs) > SMEM_BYTES and rows > 1:
        rows -= 1
    while smem(rows, cols, cs) > SMEM_BYTES and cols > 1:
        cols = (cols + 1) // 2
    while smem(rows, cols, cs) > SMEM_BYTES and cs > 1:
        cs //= 2
    if smem(rows, cols, cs) > SMEM_BYTES:
        raise ValueError(f"maxpool_stream: a {pool}x{pool} window of one "
                         f"channel exceeds the kernel's {SMEM_BYTES} B of "
                         f"shared memory")
    return rows, cols, cs


@functools.lru_cache(maxsize=None)
def _entry(suffix: str):
    fn = getattr(_build.library("maxpool_stream"),
                 f"maxpool_stream_{suffix}")
    # x, out, B, H, W, C, pool, ps, H_out, W_out, rows, cols, cs, stream
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def maxpool_stream_raw(x: torch.Tensor, *, pool: int, stride: int = 0,
                       row_block: int = 8) -> torch.Tensor:
    """x (B, H, W, C) float32 or bfloat16 -> (B, H_out, W_out, C) in x's
    dtype, VALID pooling; ``stride`` 0 means ``pool``."""
    global launches, plain_calls
    ps = stride or pool
    if x.dim() != 4:
        raise ValueError(f"maxpool_stream wants x (B,H,W,C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"maxpool_stream: x is {x.dtype}, want one of "
                         f"{list(DTYPES)}")
    B, H, W, C = x.shape
    if pool < 1 or ps < 1 or row_block < 1 or H < pool or W < pool:
        raise ValueError(f"maxpool_stream: pool {pool}, stride {ps} and "
                         f"row_block {row_block} must be >= 1 and the "
                         f"input {H}x{W} at least the pool")
    if x.device.type == "cpu":
        plain_calls += 1
        return maxpool_stream_plain(x, pool=pool, stride=ps,
                                    row_block=row_block)
    if x.device.type != "cuda":
        raise ValueError(f"maxpool_stream runs on cuda (kernel) or cpu "
                         f"(plain version), not {x.device}")
    x = x.contiguous()
    h_out, w_out = pooled_size(H, pool, ps), pooled_size(W, pool, ps)
    rows, cols, cs = tiling(h_out, w_out, C, pool, ps, row_block,
                            x.element_size())
    if B > 65535 or -(-h_out // rows) > 65535:
        raise ValueError(f"maxpool_stream: batch {B} or {h_out} output "
                         f"rows exceed the kernel's 65535-block grid axes")
    out = torch.empty((B, h_out, w_out, C), dtype=x.dtype, device=x.device)
    fn = _entry(DTYPES[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), B, H, W, C, pool, ps, h_out,
                 w_out, rows, cols, cs, stream)
    if err != 0:
        raise KernelLaunchError(f"maxpool_stream launch failed with "
                                f"cudaError {err}")
    launches += 1
    return out
