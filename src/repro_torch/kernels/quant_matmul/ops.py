"""Public wrapper of the int8 quantized matmul kernel (K8), and the
symmetric quantizers that make its operands.

``quant_matmul`` runs through ``quant_matmul_raw``: the kernel, once per
call, on CUDA tensors; its plain version on CPU tensors. The reference's
op also takes ``interpret=``; the port has no interpret mode, so this one
does not.

``quantize_activations`` and ``quantize_weights`` give the reference's
values and scales bit for bit: ``torch.round`` rounds half to even as
``jnp.round`` does, and every division is by a tensor on the input's
device (on a CUDA tensor a division by a Python number runs as a
multiplication by its reciprocal, which rounds differently at ties).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_matmul.kernel import (  # noqa: F401
    launch_count, plain_count, quant_matmul_raw, reset_launch_count)


def quant_matmul(xq: torch.Tensor, wq: torch.Tensor, sx, sw, *,
                 block_m: int = 128, block_n: int = 128,
                 block_k: int = 128) -> torch.Tensor:
    """xq (M, K) int8, wq (K, N) int8, sx a scalar scale, sw (N,) scales
    -> fp32 (M, N) = ((xq @ wq) * sx) * sw. The block sizes shape only
    the plain version's walk (the reference's grid); the kernel tiles on
    its own, and its int32 sums are exact in any order."""
    return quant_matmul_raw(xq, wq, sx, sw, block_m=block_m,
                            block_n=block_n, block_k=block_k)


def _quantize(x: torch.Tensor, amax: torch.Tensor, bits: int):
    amax = torch.clamp_min(amax, 1e-8)
    qmax = 2 ** (bits - 1) - 1
    scale = amax / torch.tensor(qmax, dtype=amax.dtype, device=x.device)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return q.to(torch.int8), scale


def quantize_activations(x: torch.Tensor, bits: int = 8):
    """Symmetric per-tensor activation quantization -> (int8 values, 0-d
    scale)."""
    return _quantize(x, x.abs().max(), bits)


def quantize_weights(w: torch.Tensor, bits: int = 8):
    """Symmetric per-output-channel weight quantization of w (K, N) ->
    (int8, (N,) scales)."""
    return _quantize(w, w.abs().amax(dim=0), bits)
