"""The port's int8 quantized matmul (kernel K8) on the CPU, where its
launcher runs the plain version ``quant_matmul_plain``, against the JAX
package on the same numpy inputs:

* the plain version and the port's oracles equal (``np.array_equal``) the
  reference's ``quant_matmul_acc_ref`` and ``quant_matmul_ref`` over the
  reference test's four blockings, M = 1, K not a multiple of 4,
  operands at qmin/qmax at K = 512, and randomised shapes and blockings
  (a seed list);
* the JAX Pallas ``quant_matmul`` (interpret mode) multiplies ``sx *
  sw`` first, the oracle and the port ``(acc * sx) * sw``: the Pallas
  output equals ``acc * (sx * sw)`` on the port's exact accumulator bit
  for bit, and lies within 2 ULP of the port's (each order rounds twice,
  so the two can differ by 2 ULP: 12 of the 4096 outputs of the first
  blocking do);
* ``quant_matmul_requant_ref`` equals the reference's, saturating case
  included;
* ``quantize_activations``/``quantize_weights`` give the reference's
  values and scales, inputs at exact halves of the scale included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quant_matmul import quant_matmul as jax_quant_matmul  # noqa: E402,E501
from repro.kernels.quant_matmul import ref as jax_ref  # noqa: E402
from repro.kernels.quant_matmul.ops import \
    quantize_activations as jax_quantize_activations  # noqa: E402
from repro.kernels.quant_matmul.ops import \
    quantize_weights as jax_quantize_weights  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as k8  # noqa: E402
from repro_torch.kernels.quant_matmul import (  # noqa: E402
    quant_matmul, quant_matmul_acc_ref, quant_matmul_ref,
    quant_matmul_requant_ref)
from repro_torch.kernels.quant_matmul.ops import (  # noqa: E402
    quantize_activations, quantize_weights)

BLOCKINGS = [
    (64, 64, 64, 32, 32, 32),
    (100, 70, 50, 32, 16, 32),     # non-divisible
    (16, 256, 8, 16, 8, 64),
    (1, 64, 128, 8, 64, 32),
]


def operands(seed, M, K, N, extreme=False):
    rng = np.random.default_rng(seed)
    if extreme:
        xq = rng.choice([-128, 0, 127], (M, K)).astype(np.int8)
        wq = rng.choice([-128, 0, 127], (K, N)).astype(np.int8)
    else:
        xq = rng.integers(-128, 128, (M, K)).astype(np.int8)
        wq = rng.integers(-128, 128, (K, N)).astype(np.int8)
    sw = rng.uniform(1e-3, 2e-2, N).astype(np.float32)
    return xq, wq, np.float32(0.02), sw


def run(xq, wq, sx, sw, **blocks):
    """The public op on CPU tensors: one plain run, no launch."""
    k8.reset_launch_count()
    got = quant_matmul(torch.as_tensor(xq), torch.as_tensor(wq), sx,
                       torch.as_tensor(sw), **blocks)
    assert k8.plain_count() == 1 and k8.launch_count() == 0
    assert got.dtype == torch.float32
    return got.numpy()


def jax_oracles(xq, wq, sx, sw):
    acc = np.asarray(jax_ref.quant_matmul_acc_ref(jnp.asarray(xq),
                                                  jnp.asarray(wq)))
    out = np.asarray(jax_ref.quant_matmul_ref(jnp.asarray(xq),
                                              jnp.asarray(wq), sx,
                                              jnp.asarray(sw)))
    return acc, out


def check_against_reference(xq, wq, sx, sw, **blocks):
    acc, want = jax_oracles(xq, wq, sx, sw)
    got = run(xq, wq, sx, sw, **blocks)
    assert np.array_equal(got, want)
    x, w = torch.as_tensor(xq), torch.as_tensor(wq)
    my_acc = quant_matmul_acc_ref(x, w)
    assert my_acc.dtype == torch.int32
    assert np.array_equal(my_acc.numpy(), acc)
    assert np.array_equal(quant_matmul_ref(x, w, sx, torch.as_tensor(sw))
                          .numpy(), want)
    return got


@pytest.mark.parametrize("M,K,N,bm,bn,bk", BLOCKINGS)
def test_matches_jax_oracle_and_kernel(M, K, N, bm, bn, bk):
    xq, wq, sx, sw = operands(M * 1000 + K * 10 + N, M, K, N)
    got = check_against_reference(xq, wq, sx, sw, block_m=bm, block_n=bn,
                                  block_k=bk)
    pallas = np.asarray(jax_quant_matmul(
        jnp.asarray(xq), jnp.asarray(wq), sx, jnp.asarray(sw), block_m=bm,
        block_n=bn, block_k=bk))
    acc = quant_matmul_acc_ref(torch.as_tensor(xq), torch.as_tensor(wq))
    assert np.array_equal(pallas, acc.float().numpy() * (sx * sw)[None, :])
    np.testing.assert_array_max_ulp(got, pallas, maxulp=2)


def test_qmin_qmax_at_k512_exact():
    """The worst-case accumulator K * 128 * 128 needs 32 bits and comes
    through exactly; at unit scales the output is that integer."""
    K = 512
    xq = np.full((32, K), -128, np.int8)
    wq = np.concatenate([np.full((K, 8), -128, np.int8),
                         np.full((K, 8), 127, np.int8)], axis=1)
    sw = np.ones(16, np.float32)
    got = check_against_reference(xq, wq, np.float32(1.0), sw, block_k=128)
    assert got.max() == K * 128 * 128 and got.min() == -K * 128 * 127
    pallas = np.asarray(jax_quant_matmul(jnp.asarray(xq), jnp.asarray(wq),
                                         jnp.float32(1.0), jnp.asarray(sw),
                                         block_k=128))
    assert np.array_equal(got, pallas)


@pytest.mark.parametrize("M,K,N", [(1, 37, 19), (1, 3, 1), (5, 130, 129)])
def test_m1_and_k_not_a_multiple_of_4(M, K, N):
    xq, wq, sx, sw = operands(K, M, K, N)
    check_against_reference(xq, wq, sx, sw, block_m=8, block_n=16,
                            block_k=32)
    check_against_reference(xq, wq, sx, sw)


@pytest.mark.parametrize("seed", range(12))
def test_random_shapes_and_blockings(seed):
    rng = np.random.default_rng(1000 + seed)
    M, K, N = (int(rng.integers(1, 97)), int(rng.integers(1, 201)),
               int(rng.integers(1, 49)))
    bm, bn = int(rng.choice([8, 16, 32])), int(rng.choice([8, 16, 32]))
    bk = int(rng.choice([16, 64, 128]))
    xq, wq, sx, sw = operands(seed, M, K, N, extreme=bool(seed % 2))
    check_against_reference(xq, wq, sx, sw, block_m=bm, block_n=bn,
                            block_k=bk)


@pytest.mark.parametrize("out_scale", [1.0, 1.7, 250.0])
def test_requant_ref_equals_reference(out_scale):
    """out_scale 1.0 saturates every output at +-127."""
    rng = np.random.default_rng(3)
    K = 64
    xq = np.concatenate([np.full((4, K), 127, np.int8),
                         np.full((4, K), -128, np.int8),
                         rng.integers(-128, 128, (8, K)).astype(np.int8)])
    wq = rng.integers(-128, 128, (K, 8)).astype(np.int8)
    wq[:, 0] = 127
    sx = 0.013
    sw = np.exp(rng.uniform(np.log(1e-3), np.log(3e-2), 8))
    want = np.asarray(jax_ref.quant_matmul_requant_ref(
        jnp.asarray(xq), jnp.asarray(wq), sx, sw, out_scale))
    got = quant_matmul_requant_ref(torch.as_tensor(xq), torch.as_tensor(wq),
                                   sx, sw, out_scale)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    if out_scale == 1.0:
        assert np.array_equal(want[:4, 0], np.full(4, 127, np.int8))
        assert np.array_equal(want[4:8, 0], np.full(4, -127, np.int8))


def ties(amax: float):
    """(k + 1/2) times the scale ``amax / 127`` for k in -127..126, plus
    ``amax`` itself, so the derived scale is that one."""
    scale = np.float32(amax) / np.float32(127)
    k = np.arange(-127, 127, dtype=np.float32)
    return np.concatenate([(k + np.float32(0.5)) * scale,
                           [np.float32(amax)]]).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 6])
def test_quantizers_equal_reference(bits):
    rng = np.random.default_rng(bits)
    x = np.concatenate([rng.standard_normal(500).astype(np.float32),
                        ties(2.9137)])
    xq, sx = quantize_activations(torch.as_tensor(x), bits)
    jq, jsx = jax_quantize_activations(jnp.asarray(x), bits)
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32
    assert np.array_equal(xq.numpy(), np.asarray(jq))
    assert sx.numpy() == np.asarray(jsx)
    w = np.stack([ties(a) for a in (0.0371, 1.5, 7.25e-3)], axis=1)
    w = np.concatenate([w, rng.standard_normal((40, 3)).astype(np.float32)
                        * 1e-3])
    wq, sw = quantize_weights(torch.as_tensor(w), bits)
    jwq, jsw = jax_quantize_weights(jnp.asarray(w), bits)
    assert np.array_equal(wq.numpy(), np.asarray(jwq))
    assert np.array_equal(sw.numpy(), np.asarray(jsw))


def test_quantize_then_matmul_tracks_fp32():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((128, 128)).astype(np.float32)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    xq, sx = quantize_activations(torch.as_tensor(x))
    wq, sw = quantize_weights(torch.as_tensor(w))
    got = quant_matmul(xq, wq, sx, sw).numpy()
    ref = x @ w
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.05


@pytest.mark.parametrize("args", [
    (torch.zeros(4, 8, dtype=torch.int32), torch.zeros(8, 2,
                                                       dtype=torch.int8),
     1.0, torch.ones(2)),
    (torch.zeros(4, 8, dtype=torch.int8), torch.zeros(7, 2,
                                                      dtype=torch.int8),
     1.0, torch.ones(2)),
    (torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 2,
                                                      dtype=torch.int8),
     1.0, torch.ones(3)),
    (torch.zeros(4, 8, dtype=torch.int8, device="meta"),
     torch.zeros(8, 2, dtype=torch.int8, device="meta"), 1.0,
     torch.ones(2, device="meta")),
])
def test_launcher_rejects(args):
    with pytest.raises(ValueError):
        quant_matmul(*args)
