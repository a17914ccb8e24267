"""Launcher of the streaming conv kernel K6 (``csrc/conv_stream.cu``).

``conv2d_stream_raw`` takes a pre-padded NHWC input and HWIO weights,
checks them, and on CUDA tensors launches the hand-written kernel once on
the current stream; on CPU tensors it runs the plain version
(``ref.conv2d_stream_plain``). There is no other route: a tensor on any
other device, or a launch the CUDA runtime refuses, raises.

The executors hand K6 views (a scan step's window, a wave's channel
slice). A view whose strides nest as those of a slice of a larger
contiguous tensor is read in place; any other layout is copied to a
contiguous tensor first. The block sizes shape the plain version's walk
(and so its summation order); the CUDA kernel tiles the work its own way.

``launches`` counts launches of the hand-written kernel, one where the
launch succeeds and nowhere else; ``plain_calls`` counts the plain
version's runs on CPU tensors, which launch nothing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.conv_stream.ref import conv2d_stream_plain
from repro_torch.kernels.wave_replay.kernel import (launch_one_step,
                                                    one_step_geometry,
                                                    zero_bias)

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


def enclosing_dims(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """For a 4-d view ``t`` that is a slice of a contiguous tensor
    (N, D1, D2, D3) (full along N), return (D1, D2, D3); ``None`` when
    its strides do not nest that way."""
    if t.is_contiguous():
        return tuple(t.shape[1:])
    s0, s1, s2, s3 = t.stride()
    n0, n1, n2, n3 = t.shape
    if (s3 != 1 and n3 > 1) or s2 < n3 or s1 % s2 or s1 // s2 < n2 \
            or s0 % s1 or (s0 // s1 < n1 and n0 > 1):
        return None
    return (s0 // s1 if n0 > 1 else n1), s1 // s2, s2


def _check(x: torch.Tensor, w: torch.Tensor, stride: int) -> None:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv_stream wants x (B,H,W,Cin) and w "
                         f"(K,K,Cin,Cout), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if w.shape[0] != w.shape[1] or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv_stream: weights {tuple(w.shape)} do not "
                         f"fit input {tuple(x.shape)}")
    if stride < 1 or x.shape[1] < w.shape[0] or x.shape[2] < w.shape[0]:
        raise ValueError(f"conv_stream: input {tuple(x.shape)} smaller "
                         f"than the {w.shape[0]}x{w.shape[0]} window, or "
                         f"stride {stride} < 1")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise ValueError(f"conv_stream: {name} is {t.dtype}, want "
                             f"torch.float32")
    if w.device != x.device:
        raise ValueError(f"conv_stream: w on {w.device}, x on {x.device}")


def conv2d_stream_raw(x: torch.Tensor, w: torch.Tensor, *,
                      stride: int = 1, row_block: int = 8,
                      cout_block: int = 128,
                      cin_block: int = 128) -> torch.Tensor:
    """x (B, H, W, Cin) pre-padded; w (K, K, Cin, Cout). VALID conv.
    Returns a contiguous (B, H_out, W_out, Cout) float32 tensor."""
    global launches, plain_calls
    _check(x, w, stride)
    if x.device.type == "cpu":
        plain_calls += 1
        return conv2d_stream_plain(x, w, stride=stride, row_block=row_block,
                                   cout_block=cout_block,
                                   cin_block=cin_block)
    if x.device.type != "cuda":
        raise ValueError(f"conv_stream runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    B, H, W, Cin = x.shape
    K, Cout = w.shape[0], w.shape[3]
    H_out = (H - K) // stride + 1
    W_out = (W - K) // stride + 1
    dims = enclosing_dims(x)
    if dims is None:
        x = x.contiguous()
        dims = (H, W, Cin)
    w_dims = enclosing_dims(w)
    if w_dims is None or w_dims[0] != K:
        w = w.contiguous()
        w_dims = (K, Cin, Cout)
    span = max((B - 1) * x.stride(0) + dims[0] * dims[1] * dims[2],
               B * H_out * W_out * Cout, K * w_dims[0] * w_dims[1]
               * w_dims[2])
    if span >= 2 ** 31:
        raise ValueError(f"conv_stream: {span} elements overflow the "
                         f"kernel's 32-bit offsets")
    geom = one_step_geometry(
        batch=B, dims=dims, k=K, stride=stride, w_in=w_dims[1],
        w_stride=w_dims[2], fan=Cin, groups=1, opg=Cout, out_h=H_out,
        out_w=W_out, name="conv_stream")
    out = torch.empty((B, H_out, W_out, Cout), dtype=torch.float32,
                      device=x.device)
    launch_one_step("conv_stream", geom, x, w, zero_bias(Cout, x.device),
                    out)
    launches += 1
    return out
