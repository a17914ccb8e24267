"""The port's streaming max-pool (kernel K7) on the CPU, where its launcher
runs the plain version ``maxpool_stream_plain``, against the JAX
package's oracle ``repro/kernels/maxpool_stream/ref.py::maxpool_ref`` on
the same numpy inputs, with exact equality: the reference test's five
cases at ``row_block=4``, row blocks of 1 and 8, stride 0 (= pool),
stride > pool, ragged widths and bf16. The JAX Pallas kernel does not
build on the installed JAX, so its oracle is ``maxpool_ref``. The kernel
starts its running max at -3e38, not -inf, as the reference's kernel
does; the one documented difference is checked here too."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.maxpool_stream import maxpool_ref as jax_maxpool_ref  # noqa: E402,E501
from repro_torch.kernels.maxpool_stream import kernel as k7  # noqa: E402
from repro_torch.kernels.maxpool_stream import (maxpool_ref,  # noqa: E402
                                                maxpool_stream)
from repro_torch.kernels.maxpool_stream.kernel import tiling  # noqa: E402
from repro_torch.kernels.maxpool_stream.ref import (  # noqa: E402
    NEG, maxpool_stream_plain)

POOL_CASES = [(8, 8, 4, 2, 2), (13, 13, 8, 3, 2), (27, 27, 16, 3, 3),
              (14, 10, 4, 2, 2), (55, 55, 8, 3, 2)]


def inputs(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def jax_pool(x, pool, stride):
    return np.asarray(jax_maxpool_ref(jnp.asarray(x), pool=pool,
                                      stride=stride), np.float32)


def run(x, **kw):
    """The public op on a CPU tensor: one plain run, no launch."""
    k7.reset_launch_count()
    got = maxpool_stream(x, **kw)
    assert k7.plain_count() == 1 and k7.launch_count() == 0
    return got


@pytest.mark.parametrize("H,W,C,p,ps", POOL_CASES)
def test_matches_jax_oracle_on_reference_cases(H, W, C, p, ps):
    x = inputs(H * 100 + W, 2, H, W, C)
    want = jax_pool(x, p, ps)
    got = run(torch.as_tensor(x), pool=p, stride=ps, row_block=4)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("row_block", [1, 8])
@pytest.mark.parametrize("H,W,C,p,ps", POOL_CASES[1::2])
def test_row_block_changes_only_the_walk(H, W, C, p, ps, row_block):
    x = inputs(H + row_block, 2, H, W, C)
    got = run(torch.as_tensor(x), pool=p, stride=ps, row_block=row_block)
    assert np.array_equal(got.numpy(), jax_pool(x, p, ps))


@pytest.mark.parametrize("H,W,C,p,ps", [
    (12, 12, 3, 2, 0),          # stride 0 means stride = pool
    (13, 9, 5, 3, 0),
    (9, 11, 40, 2, 2),          # odd width: the last column is dropped
    (17, 14, 6, 2, 3),          # stride > pool skips rows and columns
    (11, 23, 33, 3, 4),
])
def test_stride_and_ragged_edges(H, W, C, p, ps):
    x = inputs(H * W, 3, H, W, C)
    got = run(torch.as_tensor(x), pool=p, stride=ps, row_block=3)
    want = jax_pool(x, p, ps)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("H,W,C,p,ps", [(13, 13, 8, 3, 2), (14, 10, 4, 2, 2)])
def test_bfloat16_keeps_its_dtype(H, W, C, p, ps):
    x = inputs(5, 2, H, W, C)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    want = np.asarray(jax_maxpool_ref(jnp.asarray(xb.float().numpy())
                                      .astype(jnp.bfloat16), pool=p,
                                      stride=ps).astype(jnp.float32))
    got = run(xb, pool=p, stride=ps, row_block=4)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


def test_minus_inf_reads_back_as_neg():
    """A window of -inf pools to -inf in the oracles and to -3e38 in the
    kernel's plain version (the reference kernel's start value)."""
    x = inputs(9, 1, 8, 8, 4)
    x[0, :2, :2, 1] = -np.inf             # the whole first window, channel 1
    x[0, 4, 5, 2] = -np.inf               # one tap of a window
    want = jax_pool(x, 2, 2)
    got = run(torch.as_tensor(x), pool=2, stride=2).numpy()
    assert want[0, 0, 0, 1] == -np.inf and got[0, 0, 0, 1] == np.float32(NEG)
    mask = np.ones(want.shape, bool)
    mask[0, 0, 0, 1] = False
    assert np.array_equal(got[mask], want[mask])
    assert np.array_equal(maxpool_ref(torch.as_tensor(x), pool=2).numpy(),
                          want)


def test_nan_propagates():
    x = inputs(11, 2, 13, 13, 3)
    x[1, 4, 6, 2] = np.nan
    want = jax_pool(x, 3, 2)
    got = run(torch.as_tensor(x), pool=3, stride=2, row_block=4).numpy()
    assert np.isnan(want).sum() > 1                 # overlapping windows
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got, want, equal_nan=True)


def test_plain_counter_moves_once_per_call():
    x = torch.as_tensor(inputs(1, 1, 9, 9, 2))
    k7.reset_launch_count()
    for n in range(1, 4):
        maxpool_stream(x, pool=3, stride=2)
        assert k7.plain_count() == n and k7.launch_count() == 0
    maxpool_stream_plain(x, pool=3, stride=2)       # not through the op
    assert k7.plain_count() == 3


def test_kernel_tiling_fits_shared_memory():
    """AlexNet's pools at fp32: the CTA's window (halo included) fits the
    48 KB a launch gets without opting in, with 32-channel slices."""
    for h_out, w_out, c, row_block in ((27, 27, 96, 8), (13, 13, 256, 8),
                                       (6, 6, 256, 8), (200, 500, 3, 8)):
        rows, cols, cs = tiling(h_out, w_out, c, 3, 2, row_block, 4)
        assert 1 <= rows <= row_block and 1 <= cols <= w_out
        assert cs == min(c, 32)
        assert ((rows - 1) * 2 + 3) * ((cols - 1) * 2 + 3) * cs * 4 \
            <= k7.SMEM_BYTES


@pytest.mark.parametrize("kw,x", [
    (dict(pool=3), torch.zeros(1, 2, 8, 4)),              # H < pool
    (dict(pool=2), torch.zeros(1, 8, 8, 4, dtype=torch.float16)),
    (dict(pool=2, row_block=0), torch.zeros(1, 8, 8, 4)),
    (dict(pool=2), torch.zeros(8, 8, 4)),
    (dict(pool=2), torch.zeros(1, 8, 8, 4, device="meta")),
])
def test_launcher_rejects(kw, x):
    with pytest.raises(ValueError):
        maxpool_stream(x, **kw)
