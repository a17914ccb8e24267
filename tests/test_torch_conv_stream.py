"""The port's streaming conv (kernel K6) on the CPU, where its launcher runs
the plain version ``conv2d_stream_plain``, against the JAX package's
oracle ``repro/kernels/conv_stream/ref.py::conv2d_ref`` on the same numpy
inputs: every kernel size, stride and input width the served path gives
K6 and more (K in {1, 3, 5, 11}, stride in {1, 2, 4}, Cin in {1, 3, 130},
the last over several cin blocks), output rows the row block does not
divide, several cout blocks, strided views as the executors hand them,
and ``ops.conv2d_stream`` with pad and bias. The JAX Pallas kernel does
not build on the installed JAX, so its oracle is ``conv2d_ref``.
Tolerance: ``FP32_TOL`` (repro_torch/kernels/wave_replay/ref.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.conv_stream.ref import conv2d_ref as jax_conv2d_ref  # noqa: E402,E501
from repro_torch.kernels.conv_stream import kernel as k6  # noqa: E402
from repro_torch.kernels.conv_stream.kernel import (  # noqa: E402
    conv2d_stream_raw, enclosing_dims)
from repro_torch.kernels.conv_stream.ops import conv2d_stream  # noqa: E402
from repro_torch.kernels.conv_stream.ref import (  # noqa: E402
    conv2d_ref, conv2d_stream_plain)
from repro_torch.kernels.wave_replay.ref import fp32_error  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small ops: one intra-op thread per process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def operands(seed, batch, h_out, w_out, k, stride, cin, cout):
    """Pre-padded x (batch, H, W, cin) for an h_out x w_out VALID output
    plus one row and column the window never reaches, He-scaled w."""
    rng = np.random.default_rng(seed)
    H = (h_out - 1) * stride + k + (stride > 1)
    W = (w_out - 1) * stride + k + (stride > 1)
    x = rng.standard_normal((batch, H, W, cin), np.float32)
    w = rng.standard_normal((k, k, cin, cout), np.float32) \
        * np.float32((2.0 / (k * k * cin)) ** 0.5)
    return x, w


def check(got, want):
    err, tol = fp32_error(got, want)
    assert err <= tol, (err, tol)
    assert float(np.abs(want).max()) > 0.1          # a non-trivial output


@pytest.mark.parametrize("cin", [1, 3, 130])
@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 3, 5, 11])
def test_plain_version_matches_jax_oracle(k, stride, cin):
    # 11 output rows: the default 8-row block leaves a ragged last block
    x, w = operands(k * 100 + stride * 10 + cin, 2, 11, 6, k, stride, cin,
                    9)
    want = np.asarray(jax_conv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                     stride=stride))
    k6.reset_launch_count()
    got = conv2d_stream_raw(torch.as_tensor(x), torch.as_tensor(w),
                            stride=stride)
    assert k6.plain_count() == 1 and k6.launch_count() == 0
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == want.shape == (2, 11, 6, 9)
    check(got, want)


@pytest.mark.parametrize("row_block,cout_block,cin_block",
                         [(3, 128, 128), (8, 64, 48), (1, 5, 1)])
def test_block_sizes_change_only_the_walk(row_block, cout_block, cin_block):
    """Rows, output channels and input channels cut into blocks that do
    not divide them (several cout and cin blocks)."""
    x, w = operands(7, 2, 13, 5, 3, 1, 130, 140)
    want = np.asarray(jax_conv2d_ref(jnp.asarray(x), jnp.asarray(w)))
    got = conv2d_stream_plain(torch.as_tensor(x), torch.as_tensor(w),
                              row_block=row_block, cout_block=cout_block,
                              cin_block=cin_block)
    check(got, want)


def test_strided_views_as_the_executors_hand_them():
    """A scan step's window and weight chunk, and a wave's one-channel
    slice of the gathered windows, are views; the launcher reads them in
    place on the card, so their enclosing extents must be recovered."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((2, 17, 16, 40), np.float32)
    wbase = rng.standard_normal((3, 3, 40, 24), np.float32) * 0.2
    xb, wb = torch.as_tensor(base), torch.as_tensor(wbase)
    views = [(xb[:, 1:14, 2:12, 5:21], wb[:, :, 5:21, 3:19]),
             (xb[..., 7:8], wb[:, :, 7:8, :])]
    for xv, wv in views:
        assert not xv.is_contiguous()
        assert enclosing_dims(xv) == (17, 16, 40)
        assert enclosing_dims(wv) == (3, 40, 24)
        want = np.asarray(jax_conv2d_ref(jnp.asarray(xv.numpy()),
                                         jnp.asarray(wv.numpy())))
        check(conv2d_stream_raw(xv, wv), want)
    t = xb.transpose(1, 2)
    assert enclosing_dims(t) is None                  # copied on the card
    assert enclosing_dims(xb) == (17, 16, 40)
    check(conv2d_stream_raw(t, wb),
          np.asarray(jax_conv2d_ref(jnp.asarray(t.numpy()),
                                    jnp.asarray(wbase))))


@pytest.mark.parametrize("pad,stride", [(0, 1), (1, 1), (2, 2)])
def test_ops_conv2d_stream_pad_and_bias(pad, stride):
    x, w = operands(11 + pad, 2, 9, 7, 3, stride, 5, 6)
    b = np.random.default_rng(5).standard_normal((6,), np.float32)
    want = np.asarray(jax_conv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                     stride=stride, pad=pad)) + b
    got = conv2d_stream(torch.as_tensor(x), torch.as_tensor(w),
                        torch.as_tensor(b), stride=stride, pad=pad)
    check(got, want)
    # the port's own direct oracle agrees
    check(conv2d_ref(torch.as_tensor(x), torch.as_tensor(w), stride=stride,
                     pad=pad) + torch.as_tensor(b), want)


def test_launcher_rejects_what_the_kernel_cannot_take():
    x = torch.zeros((1, 8, 8, 3))
    with pytest.raises(ValueError, match="do not fit"):
        conv2d_stream_raw(x, torch.zeros((3, 3, 4, 2)))
    with pytest.raises(ValueError, match="smaller"):
        conv2d_stream_raw(x, torch.zeros((9, 9, 3, 2)))
    with pytest.raises(ValueError, match="float32"):
        conv2d_stream_raw(x.double(), torch.zeros((3, 3, 3, 2)).double())
    with pytest.raises(ValueError, match="runs on cuda"):
        conv2d_stream_raw(x.to("meta"), torch.zeros((3, 3, 3, 2),
                                                    device="meta"))
