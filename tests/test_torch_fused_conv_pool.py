"""The port's fused conv + ReLU + max-pool (kernel K5) on the CPU, where its
launcher runs the plain version ``fused_conv_pool_plain``, against the JAX
package on the same numpy inputs: pool/stride in {2/2, 3/2, 3/3}, groups
in {1, 2}, with and without bias and pad, always with pooled rows that do
not fill the last row block; AlexNet-like stride-4 and grouped cases; and
``ops.fused_conv_pool``. The JAX Pallas kernel does not build on the
installed JAX, so the oracles are ``repro/kernels/fused_conv_pool/ref.py::
conv_pool_ref`` (non-overlapping pools, one group, no bias) and the JAX
``conv2d_direct`` -> bias -> ReLU -> ``maxpool_direct`` (the rest).
Tolerance: ``FP32_TOL`` (repro_torch/kernels/wave_replay/ref.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.streaming import conv2d_direct as jax_conv2d  # noqa: E402
from repro.core.streaming import maxpool_direct as jax_maxpool  # noqa: E402
from repro.kernels.fused_conv_pool.ref import \
    conv_pool_ref as jax_conv_pool_ref  # noqa: E402
from repro_torch.kernels.fused_conv_pool import kernel as k5  # noqa: E402
from repro_torch.kernels.fused_conv_pool.kernel import \
    fused_conv_pool_raw  # noqa: E402
from repro_torch.kernels.fused_conv_pool.ops import \
    fused_conv_pool  # noqa: E402
from repro_torch.kernels.fused_conv_pool.ref import (  # noqa: E402
    conv_pool_ref, fused_conv_pool_plain)
from repro_torch.kernels.wave_replay.ref import fp32_error  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small ops: one intra-op thread per process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_oracle(x, w, b, *, stride, pad, pool, ps, relu, groups):
    if ps == pool and groups == 1 and b is None and relu:
        xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        return np.asarray(jax_conv_pool_ref(jnp.asarray(xp), jnp.asarray(w),
                                            stride=stride, pool=pool))
    y = jax_conv2d(jnp.asarray(x), jnp.asarray(w), stride, pad, groups)
    if b is not None:
        y = y + jnp.asarray(b)
    if relu:
        y = jnp.maximum(y, 0)
    return np.asarray(jax_maxpool(y, pool, ps))


def operands(seed, *, hp, wp, pool, ps, k, stride, pad, cin, cout, groups,
             bias, batch=2):
    """Inputs whose conv output has ``hp`` x ``wp`` pooled rows and
    columns plus one conv row and column the pool never reads."""
    rng = np.random.default_rng(seed)
    h_out = (hp - 1) * ps + pool + 1
    w_out = (wp - 1) * ps + pool + 1
    H = (h_out - 1) * stride + k - 2 * pad
    W = (w_out - 1) * stride + k - 2 * pad
    x = rng.standard_normal((batch, H, W, cin), np.float32)
    w = rng.standard_normal((k, k, cin // groups, cout), np.float32) \
        * np.float32((2.0 / (k * k * cin / groups)) ** 0.5)
    b = rng.standard_normal((cout,), np.float32) * np.float32(0.5) \
        if bias else None
    return x, w, b


def check(got, want, shape):
    assert tuple(got.shape) == want.shape == shape
    err, tol = fp32_error(got, want)
    assert err <= tol, (err, tol)
    assert float(np.abs(want).max()) > 0.1


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("pool,ps", [(2, 2), (3, 2), (3, 3)])
def test_matches_jax_oracles(pool, ps, groups, bias, pad):
    # 5 pooled rows: the 8-conv-row block holds 4 (2/2), 3 (3/2) or 2
    # (3/3) of them, so the last block is never full
    seed = pool * 1000 + ps * 100 + groups * 10 + bias * 2 + pad
    x, w, b = operands(seed, hp=5, wp=4, pool=pool, ps=ps, k=3, stride=1,
                       pad=pad, cin=6, cout=10, groups=groups, bias=bias)
    kw = dict(stride=1, pool=pool, relu=True, groups=groups)
    want = jax_oracle(x, w, b, pad=pad, ps=ps, **kw)
    t = [None if a is None else torch.as_tensor(a) for a in (x, w, b)]
    k5.reset_launch_count()
    got = fused_conv_pool(*t, pad=pad, pool_stride=ps, **kw)
    # one run of the plain version, every group inside it
    assert k5.plain_count() == 1 and k5.launch_count() == 0
    check(got, want, (2, 5, 4, 10))


@pytest.mark.parametrize("case", ["alexnet_conv1_like", "grouped_pad2",
                                  "no_relu", "row_block_3"])
def test_plain_version_on_served_shapes(case):
    spec = {
        # stride 4, K 11, pool 3/2 (AlexNet conv1 at a narrower width)
        "alexnet_conv1_like": (dict(hp=4, wp=3, pool=3, ps=2, k=11,
                                    stride=4, pad=0, cin=3, cout=12,
                                    groups=1, bias=True), {}),
        # AlexNet conv2's structure: K 5, pad 2, two groups, 3/2
        "grouped_pad2": (dict(hp=5, wp=5, pool=3, ps=2, k=5, stride=1,
                              pad=2, cin=8, cout=16, groups=2, bias=True),
                         {}),
        "no_relu": (dict(hp=3, wp=3, pool=2, ps=2, k=3, stride=2, pad=1,
                         cin=5, cout=7, groups=1, bias=True),
                    dict(relu=False)),
        "row_block_3": (dict(hp=6, wp=2, pool=3, ps=2, k=3, stride=1,
                             pad=0, cin=140, cout=130, groups=1,
                             bias=False),
                        dict(row_block=3, cout_block=64, cin_block=64)),
    }[case]
    shape_kw, call_kw = spec
    x, w, b = operands(len(case), **shape_kw)
    relu = call_kw.pop("relu", True)
    pad = shape_kw["pad"]
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    kw = dict(stride=shape_kw["stride"], pool=shape_kw["pool"],
              pool_stride=shape_kw["ps"], relu=relu,
              groups=shape_kw["groups"])
    want = jax_oracle(x, w, b, pad=pad, ps=shape_kw["ps"],
                      **{k: v for k, v in kw.items() if k != "pool_stride"})
    got = fused_conv_pool_plain(
        torch.as_tensor(xp), torch.as_tensor(w),
        None if b is None else torch.as_tensor(b), **kw, **call_kw)
    check(got, want, (2, shape_kw["hp"], shape_kw["wp"],
                      shape_kw["cout"]))
    # the port's direct oracle agrees
    check(conv_pool_ref(torch.as_tensor(xp), torch.as_tensor(w),
                        None if b is None else torch.as_tensor(b), **kw),
          want, tuple(got.shape))


def test_launcher_rejects_what_the_kernel_cannot_take():
    x = torch.zeros((1, 9, 9, 4))
    w = torch.zeros((3, 3, 2, 6))
    with pytest.raises(ValueError, match="skip rows"):
        fused_conv_pool_raw(x, w, groups=2, pool=2, pool_stride=3)
    with pytest.raises(ValueError, match="smaller than pool"):
        fused_conv_pool_raw(x, w, groups=2, pool=8)
    with pytest.raises(ValueError, match="group"):
        fused_conv_pool_raw(x, w, groups=1)
    with pytest.raises(ValueError, match="bias"):
        fused_conv_pool_raw(x, w, torch.zeros(5), groups=2)
    with pytest.raises(ValueError, match="runs on cuda"):
        fused_conv_pool_raw(x.to("meta"), w.to("meta"), groups=2)
