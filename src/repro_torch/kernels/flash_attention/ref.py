"""Plain PyTorch versions of the flash-attention forward kernel (K9).

``attention_ref`` is the oracle: a dense masked softmax in fp32 that
returns q's dtype. ``flash_attention_plain`` is the plain version of the
kernel itself: the blockwise online softmax (running max ``m``,
normaliser ``l``, fp32 accumulator) over the reference kernel's (q block,
kv block) grid, with its block skipping and its masks; the batch and the
heads ride along (each KV head's ``G`` query heads read it in place). The
launcher runs it for CPU tensors; ``chip_smoke.py`` holds the CUDA kernel
against it and the oracle.

As in the reference, ``window`` applies only when ``causal``; without it
the window is ignored, by the kernel and the oracle alike.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,H,S,D); k,v (B,KV,T,D). fp32 softmax; returns q.dtype."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, S, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * (D ** -0.5)
    if causal:
        qp = torch.arange(S, device=q.device)[:, None]
        kp = torch.arange(T, device=q.device)[None, :]
        mask = kp <= qp
        if window > 0:
            mask &= kp > (qp - window)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(B, H, S, D).to(q.dtype)


def block_runs(i: int, j: int, bq: int, bk: int, causal: bool,
               window: int) -> bool:
    """Whether kv block ``j`` can reach any row of q block ``i``: the
    reference kernel skips the causal upper triangle and the blocks below
    the window."""
    run = True
    if causal:
        run = j * bk <= i * bq + bq - 1
        if window > 0:
            run = run and (i * bq - window) < (j * bk + bk)
    return run


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          block_q: int = 128,
                          block_k: int = 128) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, KV, T, D); H = KV * G. Returns (B, H, S,
    D) in q's dtype."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    bq, bk = min(block_q, S), min(block_k, T)
    qg = q.reshape(B, KV, G, S, D)
    kg, vg = k[:, :, None], v[:, :, None]
    out = torch.empty((B, KV, G, S, D), dtype=q.dtype, device=q.device)
    for i in range(-(-S // bq)):
        qb = qg[..., i * bq:(i + 1) * bq, :].float()
        q_pos = (i * bq + torch.arange(qb.shape[-2],
                                       device=q.device))[:, None]
        m = torch.full(qb.shape[:-1] + (1,), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for j in range(-(-T // bk)):
            if not block_runs(i, j, bq, bk, causal, window):
                continue
            kb = kg[..., j * bk:(j + 1) * bk, :].float()
            vb = vg[..., j * bk:(j + 1) * bk, :].float()
            s = (qb @ kb.transpose(-1, -2)) * scale
            k_pos = (j * bk + torch.arange(kb.shape[-2],
                                           device=q.device))[None, :]
            mask = k_pos < T
            if causal:
                mask = mask & (k_pos <= q_pos)
                if window > 0:
                    mask = mask & (k_pos > q_pos - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ vb
            m = m_new
        out[..., i * bq:(i + 1) * bq, :] = (
            acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.reshape(B, H, S, D)
