"""Public wrapper of the flash-attention forward kernel (K9).

``flash_attention`` runs through ``flash_attention_raw``: the kernel,
once per call, on CUDA tensors; its plain version on CPU tensors. The
reference's op also takes ``interpret=``; the port has no interpret mode,
so this one does not.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    flash_attention_raw, launch_count, plain_count, reset_launch_count)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, KV, T, D); H = KV * G. Returns (B, H, S,
    D) in q's dtype; ``window`` (0: none) applies only when ``causal``.
    ``block_q`` and ``block_k`` shape only the plain version's walk (the
    reference's grid); the kernel keeps its own tiles (64 queries by 32
    keys)."""
    return flash_attention_raw(q, k, v, causal=causal, window=window,
                               block_q=block_q, block_k=block_k)
