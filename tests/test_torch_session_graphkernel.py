"""The port's ``StreamingSession(mode="graphkernel")`` on the CPU (the
plain versions of K2 and K4) against the JAX package and against the
port's megakernel session: AlexNet at 227x227 and full width at fp32 and
int8, two fused chains per forward. Chain partitions and
``(total_steps, 14)`` tables equal the reference's; fp32 outputs are
within ``FP32_TOL`` of the JAX reference and equal to the megakernel
session's; raw int8 outputs are ``array_equal`` to the JAX int32 walk
over the carried ``QuantizedGraph`` and to the megakernel session's.
ResNet-18 and MobileNet-v1 run in test_torch_session_graphkernel_zoo.py
with the helpers defined here, so that parallel test workers share the
work."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import model_zoo as jzoo  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.models.cnn import init_graph_weights as jax_init  # noqa: E402
from repro.quant.accuracy import \
    quant_graph_reference_acts as jax_quant_acts  # noqa: E402
from repro.quant.calibrate import calibrate_graph as jax_calibrate  # noqa: E402,E501
from repro_torch.core import model_zoo as tzoo  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402
from repro_torch.kernels.wave_replay import graph as k2  # noqa: E402
from repro_torch.kernels.wave_replay import kernel as k1  # noqa: E402
from repro_torch.kernels.wave_replay.ref import fp32_error  # noqa: E402
from repro_torch.kernels.wave_replay_q import graph as k4  # noqa: E402
from repro_torch.kernels.wave_replay_q import kernel as k3  # noqa: E402
from repro_torch.launch.session import StreamingSession  # noqa: E402
from repro_torch.models.cnn import weights_from_numpy  # noqa: E402
from repro_torch.quant.calibrate import quantized_graph_from_numpy  # noqa: E402,E501

BATCH = 2
ZOO = {"alexnet": {}, "resnet18": dict(in_hw=32, width=8),
       "mobilenet_v1": dict(in_hw=32, width=8)}


@functools.lru_cache(maxsize=None)
def pair(name, batch=BATCH):
    """(jax graph, jax weights, port graph, port weights on the CPU,
    ``batch`` seeded numpy images)."""
    jg = jzoo.network_graph(name, **ZOO[name])
    tg = tzoo.network_graph(name, **ZOO[name])
    jw = jax_init(jg, jax.random.key(0))
    np_w = {n: (np.asarray(w), np.asarray(b)) for n, (w, b) in jw.items()}
    x = np.random.default_rng(1).standard_normal(
        (batch,) + tuple(tg.in_shape), np.float32)
    return jg, jw, tg, weights_from_numpy(tg, np_w, "cpu"), x


@functools.lru_cache(maxsize=None)
def carried(name):
    """The JAX package's calibration on two seeded images, and the
    port's copy of it."""
    jg, jw, tg, _, _ = pair(name)
    calib = np.random.default_rng(7).standard_normal(
        (2,) + tuple(tg.in_shape), np.float32)
    jqg = jax_calibrate(jg, jw, jnp.asarray(calib))
    return jqg, quantized_graph_from_numpy(tg, jqg.quants, jqg.scales)


@functools.lru_cache(maxsize=None)
def programs(name):
    """(jax programs, port plans, port programs) at the 128 KB plans,
    planned once per graph for every check and session here."""
    jg, _, tg, _, _ = pair(name)
    tplans = tstream.plan_graph(tg)
    return (jstream.compile_graph(jg, jstream.plan_graph(jg)), tplans,
            tstream.compile_graph(tg, tplans))


def sessions(name, batch=BATCH, **kw):
    """(graphkernel session, megakernel session) on the CPU."""
    _, _, tg, tw, _ = pair(name)
    weights = None if kw.get("precision") == "int8" else tw
    plans = programs(name)[1]
    return [StreamingSession(tg, plans, weights, max_batch=batch,
                             device="cpu", mode=mode, **kw)
            for mode in ("graphkernel", "megakernel")]


def reset():
    for k in (k1, k2, k3, k4):
        k.reset_launch_count()


def check_chains_and_tables(name, chains, batch):
    jg, _, tg, _, _ = pair(name)
    jprogs, _, tprogs = programs(name)
    for quantized in (False, True):
        jc, jk, jgk = jstream.graph_chain_programs(
            jg, jprogs, quantized=quantized, batch=batch)
        tc, tk, tgk = tstream.graph_chain_programs(
            tg, tprogs, quantized=quantized, batch=batch)
        assert [(c.convs, c.input_value, c.output_value) for c in tc] == \
            [(c.convs, c.input_value, c.output_value) for c in jc]
        assert [len(c.convs) for c in tc] == chains
        assert list(tgk) == list(jgk)
        for head in jgk:
            t, j = tgk[head], jgk[head]
            np.testing.assert_array_equal(t.operand_table(),
                                          j.operand_table())
            assert t.arena.slots == j.arena.slots
            assert t.arena.slot_shapes == j.arena.slot_shapes
            assert [(v.name, v.birth, v.death, v.shape, v.pad)
                    for v in t.arena.values] == \
                [(v.name, v.birth, v.death, v.shape, v.pad)
                 for v in j.arena.values]
            assert (t.node_steps, t.w_offsets, t.b_offsets, t.batch_block,
                    t.input_in_arena) == (j.node_steps, j.w_offsets,
                                          j.b_offsets, j.batch_block,
                                          j.input_in_arena)


def test_alexnet_chain_partition_and_tables_match_jax():
    check_chains_and_tables("alexnet", [2, 3], BATCH)


def test_alexnet_227_full_width_fp32_two_chains_per_forward():
    jg, jw, tg, tw, x = pair("alexnet")
    sess, mega = sessions("alexnet")
    reset()
    y = sess.run_batch(torch.as_tensor(x))
    assert k2.plain_count() == 2 and k1.plain_count() == 0
    assert k2.launch_count() == k1.launch_count() == 0
    want = mega.run_batch(torch.as_tensor(x))
    assert k1.plain_count() == 5
    assert torch.equal(y, want)
    ref = np.asarray(jstream.run_graph_reference(
        jg, jw, jnp.asarray(x))[jg.output])
    assert y.shape == ref.shape == (BATCH, 6, 6, 256)
    err, tol = fp32_error(y, ref)
    assert err <= tol and np.abs(ref).max() > 1.0
    # a second call replays the same forward and tables
    sess.run_batch(torch.as_tensor(x))
    assert sess.compile_count == 1 and k2.plain_count() == 4
    h = sess.health()
    assert h["mode"] == "graphkernel" and h["launches_per_forward"] == 2
    assert set(h["node_modes"].values()) == {"graphkernel"}
    assert h["counters"]["plain_calls_graph"] == 4
    assert h["counters"]["kernel_launches_graph"] == 0
    d = sess.describe().splitlines()
    assert len(d) == 3 and d[1].strip().startswith("conv1+conv2:")
    assert d[2].strip().startswith("conv3+conv4+conv5:")
    assert mega.health()["launches_per_forward"] == 5


def test_alexnet_227_full_width_int8_bit_exact_to_jax_int32_walk():
    jg, _, tg, _, x = pair("alexnet")
    jqg, qg = carried("alexnet")
    raw, raw_mega = sessions("alexnet", precision="int8", qnet=qg,
                             dequantize=False)
    reset()
    got = raw.run_batch(torch.as_tensor(x))
    assert k4.plain_count() == 2 and k3.plain_count() == 0
    assert k4.launch_count() == 0
    want = np.asarray(jax_quant_acts(jqg, jnp.asarray(x))[jg.output])
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.count_nonzero(want) > 0.05 * want.size
    assert torch.equal(got, raw_mega.run_batch(torch.as_tensor(x)))
    sess, mega = sessions("alexnet", precision="int8", qnet=qg)
    y = sess.run_batch(torch.as_tensor(x))
    assert y.dtype == torch.float32
    assert torch.equal(y, mega.run_batch(torch.as_tensor(x)))
    h = sess.health()
    assert h["precision"] == "int8" and h["launches_per_forward"] == 2
    assert h["counters"]["plain_calls_graph_q"] == 4
