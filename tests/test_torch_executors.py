"""The port's layer executors on the CPU against the JAX package's on the
same numpy inputs: ``run_layer_interpreted``, ``run_layer_scheduled`` (the
scan replay) and ``run_layer_wave``, and ``run_layer_streamed`` in each
mode, with the direct-conv backend (``conv_backend="xla"``) on both sides
and, on the port's side, also with the streaming conv kernel's plain
version (``conv_backend="pallas"``, K6). Cases: every AlexNet layer at
227x227 and full width (batch 1, the session's 128 KB plans: conv3's 256
one-channel waves, the grouped conv2/conv4/conv5), a multi-wave chain over
a 2x2 tile grid, a grouped layer with ``feat_splits > 1`` and a depthwise
MobileNet-v1 layer at small width. The executors are not bit-identical to
the tile loop even in the reference, so everything is held to
``FP32_TOL`` (repro_torch/kernels/wave_replay/ref.py). Also: the modes the
layer level does not serve yet raise, and ``conv2d_direct`` runs with
cuDNN's TF32 off."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import decomposition as jdec  # noqa: E402
from repro.core import model_zoo as jzoo  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro_torch.core import decomposition as tdec  # noqa: E402
from repro_torch.core import model_zoo as tzoo  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402
from repro_torch.core.schedule import (compile_layer,  # noqa: E402
                                       partition_waves)
from repro_torch.kernels.conv_stream import kernel as k6  # noqa: E402
from repro_torch.kernels.wave_replay.ref import fp32_error  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small ops: one intra-op thread per process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SRAM = 128 * 1024


def layer_case(name):
    """(jax layer, jax plan, port layer, port plan) of a named case."""
    if name.startswith("alexnet."):
        node = name.split(".")[1]
        jl = jzoo.network_graph("alexnet").node(node).layer
        tl = tzoo.network_graph("alexnet").node(node).layer
        return (jl, jdec.plan_decomposition(jl, SRAM), tl,
                tdec.plan_decomposition(tl, SRAM))
    if name == "mobilenet_v1.dw2":
        jl = jzoo.network_graph("mobilenet_v1", in_hw=32,
                                width=8).node("dw2").layer
        tl = tzoo.network_graph("mobilenet_v1", in_hw=32,
                                width=8).node("dw2").layer
        split = (2, 2, 1, 1)
    else:
        args, kw, split = {
            "multi_wave_chain": (("mw", 12, 12, 16, 8, 3), dict(pad=1),
                                 (2, 2, 1, 4)),
            "grouped_feat_splits": (("gf", 12, 11, 8, 12, 3),
                                    dict(pad=1, groups=2), (2, 1, 2, 1)),
        }[name]
        jl, tl = jdec.ConvLayer(*args, **kw), tdec.ConvLayer(*args, **kw)
    return jl, jdec.evaluate(jl, *split), tl, tdec.evaluate(tl, *split)


def operands(l, seed, batch=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, l.in_h, l.in_w, l.in_c), np.float32)
    fan = l.kernel ** 2 * (l.in_c // l.groups)
    w = rng.standard_normal((l.kernel, l.kernel, l.in_c // l.groups,
                             l.out_c), np.float32) \
        * np.float32((2.0 / fan) ** 0.5)
    b = rng.standard_normal((l.out_c,), np.float32) * np.float32(0.1)
    return x, w, b


def check(got, want):
    assert tuple(got.shape) == want.shape
    err, tol = fp32_error(got, want)
    assert err <= tol, (err, tol)


CASES = ["alexnet.conv1", "alexnet.conv2", "alexnet.conv3", "alexnet.conv4",
         "alexnet.conv5", "multi_wave_chain", "grouped_feat_splits",
         "mobilenet_v1.dw2"]


@pytest.mark.parametrize("case", CASES)
def test_layer_executors_match_the_reference(case):
    jl, jplan, tl, tplan = layer_case(case)
    assert tplan is not None and jplan.tiles_h == tplan.tiles_h \
        and jplan.in_splits == tplan.in_splits
    x, w, b = operands(tl, sum(map(ord, case)))
    want = {mode: np.asarray(jstream.run_layer_streamed(
        jl, jplan, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        mode=mode)) for mode in ("interpret", "scan", "wave")}
    assert float(np.abs(want["wave"]).max()) > 0.1
    tx, tw, tb = map(torch.as_tensor, (x, w, b))
    prog = compile_layer(tl, tplan)
    wprog = partition_waves(prog)
    check(tstream.run_layer_interpreted(tl, tplan, tx, tw, tb),
          want["interpret"])
    check(tstream.run_layer_scheduled(prog, tx, tw, tb), want["scan"])
    check(tstream.run_layer_wave(wprog, tx, tw, tb), want["wave"])
    for mode in ("interpret", "scan", "jit", "wave"):
        ref = want["scan" if mode == "jit" else mode]
        check(tstream.run_layer_streamed(tl, tplan, tx, tw, tb, mode=mode),
              ref)
    # K6's plain version as the per-step conv: one run per single-group
    # wave (wave) or step (scan), the direct grouped conv elsewhere
    for mode, runs in (("wave", wprog.n_waves
                        if wprog.dispatch_groups == 1 else 0),
                       ("scan", prog.n_steps if prog.gcount == 1 else 0)):
        k6.reset_launch_count()
        got = tstream.run_layer_streamed(tl, tplan, tx, tw, tb, mode=mode,
                                         conv_backend="pallas")
        assert k6.plain_count() == runs and k6.launch_count() == 0
        check(got, want[mode])


def test_alexnet_plans_dispatch_as_the_reference_plans():
    """The wave and scan structure the launch counts follow."""
    g = tzoo.network_graph("alexnet")
    got = {}
    for n in g.conv_nodes():
        prog = compile_layer(n.layer, tdec.plan_decomposition(n.layer, SRAM))
        wp = partition_waves(prog)
        got[n.name] = (wp.n_waves, wp.dispatch_groups, prog.n_steps,
                       prog.gcount)
    assert got == {"conv1": (1, 1, 14, 1), "conv2": (1, 2, 24, 1),
                   "conv3": (256, 1, 1024, 1), "conv4": (1, 2, 48, 1),
                   "conv5": (1, 2, 32, 1)}


def test_layer_modes_not_ported_raise():
    tl = tdec.ConvLayer("l", 8, 8, 4, 6, 3, pad=1)
    plan = tdec.plan_decomposition(tl, SRAM)
    x, w, b = map(torch.as_tensor, operands(tl, 0))
    with pytest.raises(NotImplementedError, match="item 3"):
        tstream.run_layer_streamed(tl, plan, x, w, b, mode="megakernel")
    with pytest.raises(NotImplementedError, match="item 3"):
        tstream.run_layer_streamed(tl, plan, x, w, b, mode="graphkernel")
    with pytest.raises(NotImplementedError, match="item 5"):
        tstream.run_layer_streamed(tl, plan, x, w, b, mode="megakernel",
                                   precision="int8")
    # as in the reference: int8 has no wave/scan datapath at all
    with pytest.raises(ValueError, match="megakernel"):
        tstream.run_layer_streamed(tl, plan, x, w, b, precision="int8")
    with pytest.raises(ValueError, match="unknown executor mode"):
        tstream.run_layer_streamed(tl, plan, x, w, b, mode="bogus")
    with pytest.raises(ValueError, match="declared"):
        tstream.run_layer_streamed(tl, plan, x[:, :7], w, b, mode="wave")


def test_conv2d_direct_runs_with_tf32_off(monkeypatch):
    """cuDNN runs fp32 convolutions in TF32 unless told otherwise; the
    direct conv, a served path in wave and scan mode, turns it off for
    its own call and leaves every other cuDNN flag as it stands."""
    calls = []
    real = torch.backends.cudnn.flags

    @contextlib.contextmanager
    def recording(**kw):
        calls.append(kw)
        with real(**kw):
            assert torch.backends.cudnn.allow_tf32 is False
            yield

    monkeypatch.setattr(torch.backends.cudnn, "flags", recording)
    c = torch.backends.cudnn
    x = torch.randn(1, 6, 6, 2)
    w = torch.randn(3, 3, 2, 4)
    y = tstream.conv2d_direct(x, w, 1, 1)
    assert tuple(y.shape) == (1, 6, 6, 4)
    assert calls == [dict(enabled=c.enabled, benchmark=c.benchmark,
                          deterministic=c.deterministic, allow_tf32=False)]
    # every direct conv of the executors goes through it
    tl = tdec.ConvLayer("l", 8, 8, 4, 6, 3, pad=1)
    xs, ws, bs = map(torch.as_tensor, operands(tl, 1))
    plan = tdec.evaluate(tl, 2, 2, 1, 1)
    calls.clear()
    tstream.run_layer_streamed(tl, plan, xs, ws, bs, mode="scan")
    assert len(calls) == 4 and all(not c["allow_tf32"] for c in calls)
