"""Launcher of the fused conv + bias + ReLU + max-pool kernel K5
(``csrc/fused_conv_pool.cu``).

``fused_conv_pool_raw`` takes a pre-padded NHWC input, per-group HWIO
weights and an optional bias, checks them, and on CUDA tensors launches
the hand-written kernel once on the current stream, every conv group in
that one launch; on CPU tensors it runs the plain version
(``ref.fused_conv_pool_plain``). There is no other route: a tensor on any
other device, or a launch the CUDA runtime refuses, raises. The reference
launches its kernel once per group and folds the bias into an extra
all-ones input channel; here the bias is added before the ReLU in the
epilogue (by the kernel and the plain version alike).

``launches`` counts launches of the hand-written kernel, one where the
launch succeeds and nowhere else; ``plain_calls`` counts the plain
version's runs on CPU tensors, which launch nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.fused_conv_pool.ref import fused_conv_pool_plain
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


def pooled_shape(H: int, W: int, k: int, stride: int, pool: int,
                 ps: int) -> "tuple[int, int]":
    """(Hp, Wp) of a VALID conv of an H x W input followed by the
    (pool, ps) max-pool; raises when the pool would skip rows or the conv
    output is smaller than the pool."""
    if not 1 <= ps <= pool:
        raise ValueError(f"pool_stride {ps} must be in 1..pool ({pool}): "
                         f"a larger stride would skip rows")
    H_out = (H - k) // stride + 1
    W_out = (W - k) // stride + 1
    if H < k or W < k or H_out < pool or W_out < pool:
        raise ValueError(f"conv output {H_out}x{W_out} of a {H}x{W} input "
                         f"smaller than pool {pool}")
    return (H_out - pool) // ps + 1, (W_out - pool) // ps + 1


def fused_conv_pool_raw(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor] = None, *,
                        stride: int = 1, pool: int = 2,
                        pool_stride: int = 0, relu: bool = True,
                        groups: int = 1, row_block: int = 8,
                        cout_block: int = 128,
                        cin_block: int = 128) -> torch.Tensor:
    """x (B, H, W, Cin) pre-padded, w (K, K, Cin/groups, Cout), b (Cout,)
    or None. VALID conv + bias + ReLU + max-pool; ``pool_stride`` 0 means
    ``pool``, smaller values overlap (AlexNet's 3/2). Returns the pooled
    contiguous fp32 (B, Hp, Wp, Cout)."""
    global launches, plain_calls
    ps = pool_stride or pool
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != w.shape[1]:
        raise ValueError(f"fused_conv_pool wants x (B,H,W,Cin) and w "
                         f"(K,K,Cin/groups,Cout), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    B, H, W, Cin = x.shape
    K, Cout = w.shape[0], w.shape[3]
    if groups < 1 or Cin % groups or Cout % groups \
            or w.shape[2] != Cin // groups:
        raise ValueError(f"fused_conv_pool: weights {tuple(w.shape)} do "
                         f"not fit input {tuple(x.shape)} in {groups} "
                         f"group(s)")
    if b is not None and tuple(b.shape) != (Cout,):
        raise ValueError(f"fused_conv_pool: bias {tuple(b.shape)} != "
                         f"({Cout},)")
    if stride < 1:
        raise ValueError(f"fused_conv_pool: stride {stride} < 1")
    Hp, Wp = pooled_shape(H, W, K, stride, pool, ps)
    named = [("x", x), ("w", w)] + ([("bias", b)] if b is not None else [])
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"fused_conv_pool: {name} is {t.dtype}, want "
                             f"torch.float32")
        if t.device != x.device:
            raise ValueError(f"fused_conv_pool: {name} on {t.device}, x on "
                             f"{x.device}")
    kw = dict(stride=stride, pool=pool, pool_stride=ps, relu=relu,
              groups=groups)
    if x.device.type == "cpu":
        plain_calls += 1
        return fused_conv_pool_plain(x, w, b, row_block=row_block,
                                     cout_block=cout_block,
                                     cin_block=cin_block, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_pool runs on cuda (kernel) or cpu "
                         f"(plain version), not {x.device}")
    x, w = x.contiguous(), w.contiguous()
    bias = b.contiguous() if b is not None else zero_bias(Cout, x.device)
    for t in (x, w):
        if t.numel() >= 2 ** 31:
            raise ValueError(f"fused_conv_pool: a tensor of {t.numel()} "
                             f"elements overflows the kernel's 32-bit "
                             f"offsets")
    geom = one_step_geometry(
        batch=B, dims=(H, W, Cin), k=K, stride=stride, w_in=Cin // groups,
        w_stride=Cout, fan=Cin // groups, groups=groups,
        opg=Cout // groups, out_h=Hp, out_w=Wp, pool=pool, ps=ps,
        relu=relu, name="fused_conv_pool")
    out = torch.empty((B, Hp, Wp, Cout), dtype=torch.float32,
                      device=x.device)
    launch_one_step("fused_conv_pool", geom, x, w, bias, out)
    launches += 1
    return out
