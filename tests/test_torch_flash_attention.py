"""The port's flash-attention forward (kernel K9) on the CPU, where its
launcher runs the plain version ``flash_attention_plain``, against the
JAX package on the same numpy inputs: its oracle ``attention_ref`` and its
Pallas ``flash_attention`` (interpret mode), to 2e-5 in fp32 and 2e-2 in
bf16 (the reference test's tolerances), on the reference test's five
cases and its dtype case, block sizes that divide neither S nor T, D =
320 (d_model / n_heads of the repo's Gemma3-4B config) at a short S, a
window without causal (ignored, as in the reference), and the head ratio
check. At a longer S, where the outputs shrink towards the 2e-2 of the
bf16 tolerance, a bf16 result is held to one rounding: half a bf16 ULP
of the fp32 attention of its inputs and one ULP of the JAX oracle's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402,E501
from repro.kernels.flash_attention import \
    flash_attention as jax_flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as k9  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention)
from repro_torch.kernels.flash_attention.ref import block_runs  # noqa: E402

CASES = [
    # B, H, KV, S, T, D, causal, window
    (2, 4, 2, 64, 64, 16, True, 0),
    (1, 8, 8, 128, 128, 32, True, 0),
    (2, 4, 1, 96, 96, 16, True, 32),     # MQA + sliding window
    (1, 2, 2, 64, 64, 16, False, 0),     # bidirectional (encoder)
    (2, 4, 2, 60, 60, 16, True, 0),      # non-divisible seq
]


def inputs(seed, B, H, KV, S, T, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D), np.float32),
            rng.standard_normal((B, KV, T, D), np.float32),
            rng.standard_normal((B, KV, T, D), np.float32))


def run(q, k, v, dtype=torch.float32, **kw):
    """The public op on CPU tensors: one plain run, no launch; fp32 out."""
    k9.reset_launch_count()
    got = flash_attention(*(torch.as_tensor(a).to(dtype) for a in (q, k, v)),
                          **kw)
    assert k9.plain_count() == 1 and k9.launch_count() == 0
    assert got.dtype == dtype
    return got.float().numpy()


def jax_ref(q, k, v, causal, window, dtype=jnp.float32):
    return np.asarray(jax_attention_ref(
        *(jnp.asarray(a).astype(dtype) for a in (q, k, v)), causal=causal,
        window=window).astype(jnp.float32))


def err(a, b):
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("B,H,KV,S,T,D,causal,window", CASES)
def test_matches_jax_oracle_and_kernel(B, H, KV, S, T, D, causal, window):
    q, k, v = inputs(S * 10 + H, B, H, KV, S, T, D)
    got = run(q, k, v, causal=causal, window=window, block_q=32,
              block_k=32)
    assert err(got, jax_ref(q, k, v, causal, window)) < 2e-5
    pallas = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=32, block_k=32))
    assert err(got, pallas) < 2e-5
    mine = attention_ref(*(torch.as_tensor(a) for a in (q, k, v)),
                         causal=causal, window=window).numpy()
    assert err(mine, jax_ref(q, k, v, causal, window)) < 2e-5


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_dtypes(dtype, tol):
    q, k, v = inputs(3, 1, 4, 2, 64, 64, 16)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    # both packages start from the same rounded bf16 values
    q, k, v = (torch.as_tensor(a).to(tdt).float().numpy() for a in (q, k, v))
    got = run(q, k, v, tdt, block_q=32, block_k=32)
    assert err(got, jax_ref(q, k, v, True, 0, jdt)) < tol
    pallas = np.asarray(jax_flash_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), block_q=32,
        block_k=32).astype(jnp.float32))
    assert err(got, pallas) < tol


def bf16_ulp(x):
    """One bf16 ULP of each value of ``x`` (8 significant bits)."""
    _, e = np.frexp(x)
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("S,window", [(512, 0), (384, 96)])
def test_bf16_is_one_rounding_of_fp32(S, window):
    """The plain version scores, keeps its softmax and accumulates in
    fp32 and rounds once to bf16: within half a ULP of the fp32
    attention of the same bf16 inputs and one ULP of the JAX oracle's
    bf16 result (4e-6 of fp32 order of summation allowed on top)."""
    q, k, v = inputs(S + window, 1, 4, 2, S, S, 64)
    q, k, v = (torch.as_tensor(a).bfloat16().float().numpy()
               for a in (q, k, v))
    got = run(q, k, v, torch.bfloat16, window=window)
    exact = jax_ref(q, k, v, True, window)
    oracle = jax_ref(q, k, v, True, window, jnp.bfloat16)
    slack = 4e-6
    assert (np.abs(got - exact) - slack <= 0.5 * bf16_ulp(got)).all()
    ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(oracle)))
    assert (np.abs(got - oracle) - slack <= ulp).all()


@pytest.mark.parametrize("B,H,KV,S,T,D,causal,window,bq,bk", [
    (1, 4, 2, 100, 100, 16, True, 0, 32, 48),
    (2, 2, 1, 75, 75, 8, True, 20, 16, 24),
    (1, 2, 2, 96, 160, 16, False, 0, 40, 64),     # T != S, non-causal
    (1, 3, 3, 50, 130, 12, False, 0, 128, 128),   # one q block
])
def test_blocks_that_divide_neither_s_nor_t(B, H, KV, S, T, D, causal,
                                            window, bq, bk):
    q, k, v = inputs(S + T, B, H, KV, S, T, D)
    got = run(q, k, v, causal=causal, window=window, block_q=bq,
              block_k=bk)
    assert got.shape == (B, H, S, D)
    assert err(got, jax_ref(q, k, v, causal, window)) < 2e-5
    default = run(q, k, v, causal=causal, window=window)
    assert err(got, default) < 2e-5


@pytest.mark.parametrize("window", [0, 40])
def test_gemma_head_dim_320(window):
    q, k, v = inputs(320 + window, 1, 2, 1, 72, 72, 320)
    got = run(q, k, v, window=window, block_q=32, block_k=32)
    assert err(got, jax_ref(q, k, v, True, window)) < 2e-5


def test_window_without_causal_is_ignored():
    q, k, v = inputs(17, 1, 2, 1, 48, 48, 16)
    got = run(q, k, v, causal=False, window=8, block_q=16, block_k=16)
    assert err(got, run(q, k, v, causal=False, block_q=16,
                        block_k=16)) == 0.0
    assert err(got, jax_ref(q, k, v, False, 8)) < 2e-5
    assert err(got, jax_ref(q, k, v, False, 0)) < 2e-5


def test_block_skipping_is_the_references():
    """Skipped exactly where kernel.py:41-46 skips: the causal upper
    triangle and, with a window, the blocks wholly below it."""
    assert block_runs(0, 0, 32, 32, True, 0)
    assert not block_runs(0, 1, 32, 32, True, 0)
    assert block_runs(1, 1, 32, 32, True, 0)
    assert block_runs(3, 0, 32, 32, False, 0)
    assert not block_runs(3, 1, 32, 32, True, 32)      # 96 - 32 >= 64
    assert block_runs(3, 2, 32, 32, True, 32)
    assert block_runs(0, 5, 32, 32, False, 16)


@pytest.mark.parametrize("shapes", [
    ((1, 6, 8, 16), (1, 4, 8, 16)),     # 4 KV heads do not divide 6
    ((1, 4, 8, 16), (1, 2, 8, 8)),      # head dims differ
    ((1, 4, 8, 16), (2, 2, 8, 16)),     # batches differ
])
def test_head_ratio_and_shapes_are_checked(shapes):
    qs, ks = shapes
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks))


def test_launcher_rejects_other_devices_and_dtypes():
    z = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError):
        flash_attention(z, z, z)
    h = torch.zeros(1, 2, 8, 16, dtype=torch.float16)
    with pytest.raises(ValueError):
        flash_attention(h, h, h)
