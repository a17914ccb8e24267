"""Launcher of the int8 quantized matmul kernel K8 (``csrc/quant_matmul.cu``).

``quant_matmul_raw`` checks int8 operands and fp32 scales and on CUDA
tensors launches the hand-written kernel once on the current stream (the
reference's K-block grid axis is the loop inside each CTA); on CPU
tensors it runs the plain version (``ref.quant_matmul_plain``). There is
no other route: a tensor on any other device, or a launch the CUDA
runtime refuses, raises. The block sizes shape the plain version's walk;
the CUDA kernel tiles the work its own way, which changes no output,
since the int32 sums are exact in any order.

``launches`` counts launches of the hand-written kernel, one where the
launch succeeds and nowhere else; ``plain_calls`` counts the plain
version's runs on CPU tensors, which launch nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul.ref import (quant_matmul_plain,
                                                  scale_tensor)
from repro_torch.runtime.errors import KernelLaunchError

# |acc| <= K * 128 * 128 must stay below 2^31.
MAX_K = (2 ** 31 - 1) // (128 * 128)

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


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("quant_matmul").quant_matmul_i8
    # xq, wq, sx, sw, out, M, K, N, stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quant_matmul_raw(xq: torch.Tensor, wq: torch.Tensor, sx, sw, *,
                     block_m: int = 128, block_n: int = 128,
                     block_k: int = 128) -> torch.Tensor:
    """xq (M, K) int8, wq (K, N) int8, sx a scalar scale, sw (N,) scales.

    Returns fp32 (M, N) = ((xq @ wq) * sx) * sw, the accumulator exact in
    int32."""
    global launches, plain_calls
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"quant_matmul wants xq (M,K) and wq (K,N), got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    M, K = xq.shape
    N = wq.shape[1]
    sx, sw = scale_tensor(sx, xq.device), scale_tensor(sw, xq.device)
    if sx.numel() != 1 or tuple(sw.shape) != (N,):
        raise ValueError(f"quant_matmul: sx {tuple(sx.shape)} must be one "
                         f"scale and sw {tuple(sw.shape)} ({N},)")
    for name, t in (("xq", xq), ("wq", wq)):
        if t.dtype != torch.int8:
            raise ValueError(f"quant_matmul: {name} is {t.dtype}, want "
                             f"torch.int8")
    if wq.device != xq.device:
        raise ValueError(f"quant_matmul: wq on {wq.device}, xq on "
                         f"{xq.device}")
    if min(M, K, N, block_m, block_n, block_k) < 1 or K > MAX_K:
        raise ValueError(f"quant_matmul: M {M}, K {K}, N {N} and the blocks "
                         f"must be >= 1, and K <= {MAX_K} keeps the int32 "
                         f"accumulator exact")
    if xq.device.type == "cpu":
        plain_calls += 1
        return quant_matmul_plain(xq, wq, sx, sw, block_m=block_m,
                                  block_n=block_n, block_k=block_k)
    if xq.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda (kernel) or cpu "
                         f"(plain version), not {xq.device}")
    xq, wq = xq.contiguous(), wq.contiguous()
    sx, sw = sx.reshape(1).contiguous(), sw.contiguous()
    if -(-M // 64) > 65535:
        raise ValueError(f"quant_matmul: M {M} exceeds the kernel's "
                         f"65535-block grid axis")
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = _entry()(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
                       sw.data_ptr(), out.data_ptr(), M, K, N, stream)
    if err != 0:
        raise KernelLaunchError(f"quant_matmul_i8 launch failed with "
                                f"cudaError {err}")
    launches += 1
    return out
