"""The port's int8 primitives and calibration against the JAX package on
the same numpy inputs: entry quantization (exact halves of the scale
included), the rounding shift, requantization (the pad lanes' m=0 /
shift=31 included), ``requant_params`` and ``quantize_layer`` are
``array_equal``; the port's own calibration agrees with the JAX one to
``SCALE_RTOL``; ``quantized_graph_from_numpy`` carries a JAX calibration
across and rejects one whose scales do not chain."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import model_zoo as jzoo  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro.core.decomposition import ConvLayer as JConvLayer  # noqa: E402
from repro.models.cnn import init_graph_weights as jax_init  # noqa: E402
from repro.quant import calibrate as jcal  # noqa: E402
from repro_torch.core import model_zoo as tzoo  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.core.decomposition import ConvLayer  # noqa: E402
from repro_torch.models.cnn import weights_from_numpy  # noqa: E402
from repro_torch.quant import calibrate as tcal  # noqa: E402

# Calibration observes fp32 activations, which F.conv2d and XLA round
# differently in the last bits; the 99.9th percentile of |x| moves by
# far less than this relative to itself.
SCALE_RTOL = 1e-4

LQ_FIELDS = ("wq", "w_scale", "in_scale", "out_scale", "bias_q", "m",
             "shift", "pre_shift", "acc_bound", "fan_chunk")


def test_quantize_int8_sym_matches_jax_at_exact_halves():
    rng = np.random.default_rng(0)
    scale = np.float32(0.0371)
    k = rng.integers(-140, 140, 20000).astype(np.float32)
    halves = (k + np.float32(0.5)) * scale           # ties of round()
    x = np.concatenate([halves, rng.standard_normal(20000, np.float32) * 3,
                        np.float32([0.0, -0.0, 1e6, -1e6])])
    want = np.asarray(jq.quantize_int8_sym(jnp.asarray(x), float(scale)))
    got = tq.quantize_int8_sym(torch.as_tensor(x), float(scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.abs(want) == 127).any() and (want == 0).any()
    deq = tq.dequantize_int8(got, float(scale))
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jq.dequantize_int8(jnp.asarray(want),
                                                   float(scale))))


def test_rounding_rshift_matches_jax_with_per_channel_shifts():
    rng = np.random.default_rng(1)
    s = rng.integers(0, 32, (1, 64)).astype(np.int32)
    v = rng.integers(-2 ** 29, 2 ** 29, (200, 64)).astype(np.int32)
    # exact halves: odd multiples of 2^(s-1)
    odd = 2 * rng.integers(-2 ** 12, 2 ** 12, (50, 64)) + 1
    ties = np.where(s > 0, odd * (2.0 ** (s - 1)), odd)
    ties = np.clip(ties, -2 ** 30, 2 ** 30).astype(np.int32)
    v = np.concatenate([v, ties])
    want = np.asarray(jq.rounding_rshift(jnp.asarray(v), jnp.asarray(s)))
    got = tq.rounding_rshift(torch.as_tensor(v), torch.as_tensor(s))
    np.testing.assert_array_equal(got.numpy(), want)
    for k in (0, 3, 31):                  # a static int shift too
        np.testing.assert_array_equal(
            tq.rounding_rshift(torch.as_tensor(v), k).numpy(),
            np.asarray(jq.rounding_rshift(jnp.asarray(v), k)))


@pytest.mark.parametrize("pre_shift", [0, 2, 3])
@pytest.mark.parametrize("relu", [False, True])
def test_requantize_i32_matches_jax_pad_lanes_included(pre_shift, relu):
    rng = np.random.default_rng(10 + pre_shift)
    fan = 2304
    bound = fan * 127 * 127
    ratio = rng.uniform(0.5, 2.0, 48) * 40 / (np.sqrt(fan) * 5376)
    m, shift, ps = jq.requant_params(ratio, bound << pre_shift)
    m = np.concatenate([m, np.zeros(16, np.int32)])        # pad lanes
    shift = np.concatenate([shift, np.full(16, 31, np.int32)])
    acc = rng.integers(-bound, bound, (300, 64)).astype(np.int32)
    args = (m[None], shift[None], ps)
    want = np.asarray(jq.requantize_i32(
        jnp.asarray(acc), *map(jnp.asarray, args[:2]), ps, relu=relu))
    got = tq.requantize_i32(torch.as_tensor(acc),
                            *map(torch.as_tensor, args[:2]), ps, relu=relu)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[:, 48:].any()                # pad lanes exact zeros
    assert (want[:, :48] != 0).mean() > 0.3


def test_requant_params_matches_jax():
    rng = np.random.default_rng(2)
    for bound in (1000, 363 * 127 * 127, 2304 * 127 * 127 + 5000, 2 ** 40):
        ratio = np.exp(rng.uniform(-30, 3, 200))
        ratio[:3] = [1e-12, 2.0 ** -31, 300.0]
        for a, b in zip(tq.requant_params(ratio, bound),
                        jq.requant_params(ratio, bound)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("groups", [1, 2])
def test_quantize_layer_matches_jax_at_equal_scales(groups):
    args = ("q", 13, 13, 16, 24, 3)
    rng = np.random.default_rng(groups)
    w = rng.standard_normal((3, 3, 16 // groups, 24), np.float32) * 0.2
    w[..., 5] = 0.0                              # an all-zero channel
    b = rng.standard_normal(24).astype(np.float32)
    got = tcal.quantize_layer(ConvLayer(*args, pad=1, groups=groups),
                              torch.as_tensor(w), torch.as_tensor(b),
                              0.031, 0.047)
    want = jcal.quantize_layer(JConvLayer(*args, pad=1, groups=groups),
                               w, b, 0.031, 0.047)
    for f in LQ_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.wq.dtype == np.int8 and got.m.dtype == np.int32


def calibrated_pair(name, **kw):
    """(port graph, JAX QuantizedGraph, port QuantizedGraph calibrated by
    the port) for the same numpy weights and calibration images."""
    jg = jzoo.network_graph(name, **kw)
    tg = tzoo.network_graph(name, **kw)
    jw = jax_init(jg, jax.random.key(0))
    np_w = {n: (np.asarray(w), np.asarray(b)) for n, (w, b) in jw.items()}
    calib = np.random.default_rng(7).standard_normal(
        (2,) + tuple(tg.in_shape), np.float32)
    jqg = jcal.calibrate_graph(jg, jw, jnp.asarray(calib))
    tqg = tcal.calibrate_graph(tg, weights_from_numpy(tg, np_w, "cpu"),
                               torch.as_tensor(calib))
    return tg, jqg, tqg


@pytest.mark.parametrize("name,kw", [("alexnet", {}),
                                     ("resnet18", dict(in_hw=32, width=8))])
def test_calibrate_graph_scales_match_jax(name, kw):
    tg, jqg, tqg = calibrated_pair(name, **kw)
    assert set(tqg.scales) == set(jqg.scales)
    for v, s in jqg.scales.items():
        assert abs(tqg.scales[v] - s) <= SCALE_RTOL * s, (v, tqg.scales[v], s)
    for n in tg.conv_nodes():
        a, b = tqg.quants[n.name], jqg.quants[n.name]
        np.testing.assert_array_equal(a.wq, b.wq)
        assert a.pre_shift == b.pre_shift and a.fan_chunk == b.fan_chunk
    if name == "resnet18":                       # add scales unified
        adds = [n for n in tg.nodes if n.op == "add"]
        assert adds
        for n in adds:
            assert len({tqg.scales[v] for v in (*n.inputs, n.name)}) == 1


def test_quantized_graph_from_numpy_round_trips_and_rejects_bad_scales():
    tg, jqg, _ = calibrated_pair("resnet18", in_hw=32, width=8)
    qg = tcal.quantized_graph_from_numpy(tg, jqg.quants, jqg.scales)
    for name, q in qg.quants.items():
        for f in LQ_FIELDS:
            np.testing.assert_array_equal(getattr(q, f),
                                          getattr(jqg.quants[name], f))
    assert qg.scales == {v: float(s) for v, s in jqg.scales.items()}
    # again from plain dicts of the port's own fields
    again = tcal.quantized_graph_from_numpy(
        tg, {n: {f: getattr(q, f) for f in LQ_FIELDS}
             for n, q in qg.quants.items()}, qg.scales)
    for name, q in again.quants.items():
        for f in LQ_FIELDS:
            np.testing.assert_array_equal(getattr(q, f),
                                          getattr(qg.quants[name], f))
    wq, bq, m, s = qg.quants["stem"].device_arrays("cpu")
    assert wq.dtype == torch.int8 and m.dtype == torch.int32
    add = next(n for n in tg.nodes if n.op == "add")
    bad = dict(jqg.scales)
    bad[add.inputs[0]] *= 1.5
    with pytest.raises(ValueError, match="scale"):
        tcal.quantized_graph_from_numpy(tg, jqg.quants, bad)
    bad = dict(jqg.scales)
    bad["stem"] *= 1.5
    with pytest.raises(ValueError, match="scales"):
        tcal.quantized_graph_from_numpy(tg, jqg.quants, bad)
    quants = {n: {f: getattr(q, f) for f in LQ_FIELDS}
              for n, q in qg.quants.items()}
    quants["stem"]["m"] = quants["stem"]["m"].astype(np.int64)
    with pytest.raises(ValueError, match="int32"):
        tcal.quantized_graph_from_numpy(tg, quants, jqg.scales)
    with pytest.raises(ValueError, match="conv nodes"):
        tcal.quantized_graph_from_numpy(
            tg, {n: q for n, q in jqg.quants.items() if n != "stem"},
            jqg.scales)
