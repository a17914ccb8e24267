"""Launcher of the flash-attention forward kernel K9
(``csrc/flash_attention.cu``).

``flash_attention_raw`` checks q (B, H, S, D) and k, v (B, KV, T, D) and
on CUDA tensors launches the hand-written kernel once on the current
stream (the reference's kv-block grid axis is the loop inside each CTA);
on CPU tensors it runs the plain version (``ref.flash_attention_plain``).
There is no other route: a tensor on any other device, or a launch the
CUDA runtime refuses, raises. The block sizes shape the plain version's
walk; the CUDA kernel tiles the work its own way (64 query rows, 32 keys),
with the same skipping test on its own blocks. A skipped block is one
whose every score is masked, which would add exact zeros, so the tiling
moves the result only by the order of its fp32 sums.

``launches`` counts launches of the hand-written kernel, one where the
launch succeeds and nowhere else; ``plain_calls`` counts the plain
version's runs on CPU tensors, which launch nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.runtime.errors import KernelLaunchError

MAX_HEAD_DIM = 320          # Gemma3-4B's 2560 / 8
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


@functools.lru_cache(maxsize=None)
def _entry(suffix: str):
    fn = getattr(_build.library("flash_attention"),
                 f"flash_attention_{suffix}")
    # q, k, v, out, B, H, KV, S, T, D, causal, window, scale, stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_raw(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        block_q: int = 128,
                        block_k: int = 128) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, KV, T, D) with KV dividing H, all float32
    or all bfloat16. Scores scaled by D^-1/2, a causal mask and, with it,
    a sliding window of ``window`` keys (0: none). Returns (B, H, S, D)
    in q's dtype."""
    global launches, plain_calls
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B,H,S,D) and k, v "
                         f"(B,KV,T,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {KV} KV heads do not divide "
                         f"{H} query heads")
    if min(S, T, D, block_q, block_k) < 1 or window < 0:
        raise ValueError(f"flash_attention: S {S}, T {T}, D {D} and the "
                         f"blocks must be >= 1 and window {window} >= 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; q, k "
                             f"and v must all be one of {list(DTYPES)}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q "
                             f"on {q.device}")
    if q.device.type == "cpu":
        plain_calls += 1
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {q.device}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > the kernel's "
                         f"{MAX_HEAD_DIM}")
    if -(-S // 64) > 65535:
        raise ValueError(f"flash_attention: {S} query rows exceed the "
                         f"kernel's 65535 blocks of 64")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry(DTYPES[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            KV, S, T, D, int(causal), window, D ** -0.5, stream)
    if err != 0:
        raise KernelLaunchError(f"flash_attention launch failed with "
                                f"cudaError {err}")
    launches += 1
    return out
