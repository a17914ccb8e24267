"""The port's int8 ``StreamingSession`` on the CPU (K3's plain version)
against the JAX package's int32 reference walk
``repro/quant/accuracy.py::quant_graph_reference_acts`` over the SAME
calibrated ``QuantizedGraph``, carried across as numpy: AlexNet at
227x227 and full width, ResNet-18 (residual epilogue) and MobileNet-v1
(depthwise) at reduced size. Raw int8 outputs are ``array_equal``; the
dequantized outputs equal the reference's dequantization. Plus the int8
serving surface: int8 requests, a padded partial flush, one compile."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import model_zoo as jzoo  # noqa: E402
from repro.core.quantization import dequantize_int8 as jax_dequant  # noqa: E402,E501
from repro.models.cnn import init_graph_weights as jax_init  # noqa: E402
from repro.quant.accuracy import \
    quant_graph_reference_acts as jax_quant_acts  # noqa: E402
from repro.quant.accuracy import snr_db as jax_snr_db  # noqa: E402
from repro.quant.calibrate import calibrate_graph as jax_calibrate  # noqa: E402,E501
from repro_torch.core import decomposition as tdec  # noqa: E402
from repro_torch.core import model_zoo as tzoo  # noqa: E402
from repro_torch.core.graph import chain_graph  # noqa: E402
from repro_torch.core.quantization import (dequantize_int8,  # noqa: E402
                                           quantize_int8_sym)
from repro_torch.kernels.wave_replay import kernel as k1  # noqa: E402
from repro_torch.kernels.wave_replay_q import kernel as k3  # noqa: E402
from repro_torch.launch.session import StreamingSession  # noqa: E402
from repro_torch.models.cnn import init_graph_weights  # noqa: E402
from repro_torch.quant.accuracy import (quant_graph_reference_acts,  # noqa: E402,E501
                                        quant_reference_acts, snr_db)
from repro_torch.quant.calibrate import (calibrate_graph,  # noqa: E402
                                         calibrate_network,
                                         float_network_acts,
                                         quantized_graph_from_numpy)


def carried(name, seed=0, **kw):
    """(port graph, JAX QuantizedGraph, the port's copy of it): the JAX
    package calibrates on two seeded numpy images."""
    jg = jzoo.network_graph(name, **kw)
    tg = tzoo.network_graph(name, **kw)
    jw = jax_init(jg, jax.random.key(seed))
    calib = np.random.default_rng(seed + 7).standard_normal(
        (2,) + tuple(tg.in_shape), np.float32)
    jqg = jax_calibrate(jg, jw, jnp.asarray(calib))
    return tg, jqg, quantized_graph_from_numpy(tg, jqg.quants, jqg.scales)


def images(g, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch,) + tuple(g.in_shape), np.float32)


def check_session_against_jax(name, launches, **kw):
    """Serve two images through raw and dequantizing int8 sessions over
    the carried graph; hold both to the JAX int32 walk."""
    tg, jqg, qg = carried(name, **kw)
    x = images(tg, 2, 1)
    want = np.asarray(jax_quant_acts(jqg, jnp.asarray(x))[tg.output])
    raw = StreamingSession.for_graph(tg, None, max_batch=2, device="cpu",
                                     precision="int8", qnet=qg,
                                     dequantize=False)
    k3.reset_launch_count()
    k1.reset_launch_count()
    got = raw.run_batch(torch.as_tensor(x))
    assert k3.plain_count() == launches == len(raw.programs)
    assert k3.launch_count() == 0 and k1.plain_count() == 0
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.count_nonzero(want) > 0.05 * want.size
    # the default session dequantizes at exit, as the reference does
    sess = StreamingSession.for_graph(tg, None, max_batch=2, device="cpu",
                                      precision="int8", qnet=qg)
    y = sess.run_batch(torch.as_tensor(x))
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jax_dequant(jnp.asarray(want),
                                          jqg.scales[tg.output])))
    h = sess.health()
    assert h["precision"] == "int8" and h["counters"]["plain_calls_q"] > 0
    return qg, x, got


def test_alexnet_227_full_width_int8_bit_exact_to_jax_int32_reference():
    qg, x, got = check_session_against_jax("alexnet", 5)
    # the port's own int32 walk agrees too
    mine = quant_graph_reference_acts(qg, torch.as_tensor(x))
    assert torch.equal(mine[qg.graph.output], got)


def tiny():
    tg = chain_graph((tdec.ConvLayer("a", 8, 8, 3, 8, 3, pad=1, pool=2),
                      tdec.ConvLayer("b", 4, 4, 8, 6, 3, pad=1)),
                     name="tiny")
    tw = init_graph_weights(tg, torch.Generator().manual_seed(0), "cpu")
    calib = torch.as_tensor(images(tg, 2, 5))
    return tg, tw, calibrate_graph(tg, tw, calib)


def test_int8_requests_padded_partial_flush_one_compile():
    tg, _, qg = tiny()
    sess = StreamingSession.for_graph(tg, None, max_batch=2, device="cpu",
                                      precision="int8", qnet=qg,
                                      dequantize=False)
    x = torch.as_tensor(images(tg, 3, 6))
    xq = quantize_int8_sym(x, qg.scales["input"])
    # a batch mixing int8 codes and a float image, then a float image
    # alone; float images are quantized at entry
    tickets = [sess.submit(xq[0]), sess.submit(x[1]), sess.submit(x[2])]
    assert sess.pending == 1                  # the first two auto-flushed
    outs = [sess.result(t) for t in tickets]  # flushes the padded third
    assert sess.calls == 2 and sess.compile_count == 1
    want = quant_graph_reference_acts(qg, xq)[tg.output]
    for i, o in enumerate(outs):
        assert o.dtype == torch.int8 and torch.equal(o, want[i])
    # int8 batches are taken as codes; the int8 spec is accepted
    assert torch.equal(sess.run_batch(xq[:2]), want[:2])
    assert sess.compile_count == 1


def test_int8_session_takes_a_quantized_network_for_a_chain():
    tg, tw, qg = tiny()
    layers = [n.layer for n in tg.conv_nodes()]
    qnet = calibrate_network(layers, [tw[n.name] for n in tg.conv_nodes()],
                             torch.as_tensor(images(tg, 2, 5)))
    for n in tg.conv_nodes():        # the same calibration as the graph's
        assert np.array_equal(qnet.quants[layers.index(n.layer)].m,
                              qg.quants[n.name].m)
    x = torch.as_tensor(images(tg, 2, 8))
    by_net = StreamingSession.for_network(layers, None, max_batch=2,
                                          device="cpu", precision="int8",
                                          qnet=qnet)
    by_graph = StreamingSession.for_graph(tg, None, max_batch=2,
                                          device="cpu", precision="int8",
                                          qnet=qg)
    y = by_net.run_batch(x)
    assert torch.equal(y, by_graph.run_batch(x))
    # the linear-stack walks agree with the graph walks
    acts = quant_reference_acts(qnet, x)
    assert torch.equal(dequantize_int8(acts[-1], qnet.out_scale), y)
    ref = StreamingSession.for_graph(tg, tw, max_batch=2,
                                     device="cpu").run_batch(x)
    assert torch.equal(float_network_acts(
        layers, [tw[n.name] for n in tg.conv_nodes()], x)[-1], ref)
    assert snr_db(ref, y) > 10.0          # int8 tracks the fp32 network
    with pytest.raises(ValueError, match="layer stack"):
        StreamingSession.for_network(layers[:1], None, device="cpu",
                                     precision="int8", qnet=qnet)


def test_snr_db_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal(500)
    b = a + 0.01 * rng.standard_normal(500)
    assert snr_db(a, b) == jax_snr_db(a, b)
    assert snr_db(torch.as_tensor(a), torch.as_tensor(a)) == float("inf")


def test_int8_session_rejections():
    tg, tw, qg = tiny()
    with pytest.raises(ValueError, match="qnet"):
        StreamingSession.for_graph(tg, tw, device="cpu", precision="int8")
    with pytest.raises(ValueError, match="weights=None"):
        StreamingSession.for_graph(tg, None, device="cpu")
    other = chain_graph(tuple(n.layer for n in tg.conv_nodes()),
                        name="other")
    with pytest.raises(ValueError, match="different graph"):
        StreamingSession.for_graph(other, None, device="cpu",
                                   precision="int8", qnet=qg)
    with pytest.raises(ValueError, match="megakernel"):
        StreamingSession.for_graph(tg, None, device="cpu", mode="wave",
                                   precision="int8", qnet=qg)
    sess = StreamingSession.for_graph(tg, None, max_batch=2, device="cpu",
                                      precision="int8", qnet=qg)
    H, W, C = tg.in_shape
    with pytest.raises(ValueError, match="dtype"):
        sess.run_batch(torch.zeros(2, H, W, C, dtype=torch.int32))
