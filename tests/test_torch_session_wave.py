"""The port's ``StreamingSession`` in wave and scan mode on the CPU (each
kernel's plain version) against the JAX package on the same numpy inputs:
AlexNet at 227x227 and full width at batch 2 with each backend pair
(``conv_backend``, ``pool_backend``) = (xla, xla), (pallas, xla),
(pallas, fused), held to the JAX wave-mode session (its Pallas backends do
not build on the installed JAX) and to ``run_graph_reference``, with the
plain-version runs of K6 (the streaming conv) and K5 (the fused conv +
ReLU + pool) counted per forward (the ResNet-18 wave session is in
test_torch_session_wave_zoo.py); ``run_graph_streamed`` in every mode,
``"interpret"`` with ``track_peak``, on a residual block; and ``serve.py
--mode wave --pool-backend fused --device cpu``. Weights come from the
JAX package's ``init_graph_weights`` and cross over as numpy arrays.
Tolerance: ``FP32_TOL`` (repro_torch/kernels/wave_replay/ref.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import model_zoo as jzoo  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.launch.session import StreamingSession as JaxSession  # noqa: E402
from repro.models.cnn import init_graph_weights as jax_init  # noqa: E402
from repro_torch.core import model_zoo as tzoo  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402
from repro_torch.kernels.conv_stream import kernel as k6  # noqa: E402
from repro_torch.kernels.fused_conv_pool import kernel as k5  # noqa: E402
from repro_torch.kernels.wave_replay import kernel as k1  # noqa: E402
from repro_torch.kernels.wave_replay.ref import fp32_error  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.session import StreamingSession  # noqa: E402
from repro_torch.models.cnn import weights_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small ops: one intra-op thread per process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# K6 and K5 launches in one AlexNet forward (the session's 128 KB plans):
# wave mode runs conv1's one wave and conv3's 256 one-channel waves
# through K6 (conv2, conv4 and conv5 are grouped dispatches); scan mode
# every step (14 + 24 + 1024 + 48 + 32); a fused pool takes conv1, conv2
# and conv5 to K5, one launch each, its groups inside.
LAUNCHES = {
    ("wave", "xla", "xla"): (0, 0), ("wave", "pallas", "xla"): (257, 0),
    ("wave", "pallas", "fused"): (256, 3),
    ("scan", "xla", "xla"): (0, 0), ("scan", "pallas", "xla"): (1142, 0),
    ("scan", "pallas", "fused"): (1072, 3),
}


def pair(name, seed=0, **kw):
    """(jax graph, jax weights, port graph, port weights on the CPU)."""
    jg = jzoo.network_graph(name, **kw)
    tg = tzoo.network_graph(name, **kw)
    jw = jax_init(jg, jax.random.key(seed))
    np_w = {n: (np.asarray(w), np.asarray(b)) for n, (w, b) in jw.items()}
    return jg, jw, tg, weights_from_numpy(tg, np_w, "cpu")


def images(g, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch,) + tuple(g.in_shape), np.float32)


@pytest.fixture(scope="module")
def alexnet():
    jg, jw, tg, tw = pair("alexnet")
    x = images(tg, 2, 3)
    ref = np.asarray(jstream.run_graph_reference(jg, jw, jnp.asarray(x))
                     [jg.output])
    wave = np.asarray(JaxSession.for_graph(jg, jw, max_batch=2, mode="wave")
                      .run_batch(jnp.asarray(x)))
    assert np.abs(ref).max() > 1.0
    return tg, tw, x, ref, wave


def reset_counts():
    for k in (k1, k5, k6):
        k.reset_launch_count()


@pytest.mark.parametrize("conv_backend,pool_backend",
                         [("xla", "xla"), ("pallas", "xla"),
                          ("pallas", "fused")])
@pytest.mark.parametrize("mode", ["wave", "scan"])
def test_alexnet_227_full_width(alexnet, mode, conv_backend, pool_backend):
    tg, tw, x, ref, wave = alexnet
    sess = StreamingSession.for_graph(tg, tw, max_batch=2, device="cpu",
                                      mode=mode, conv_backend=conv_backend,
                                      pool_backend=pool_backend)
    k6_runs, k5_runs = LAUNCHES[(mode, conv_backend, pool_backend)]
    assert sess.health()["launches_per_forward_by_kernel"] is None
    reset_counts()
    y = sess.run_batch(torch.as_tensor(x))
    assert (k6.plain_count(), k5.plain_count()) == (k6_runs, k5_runs)
    assert sess.health()["launches_per_forward_by_kernel"] == \
        {"K5": k5_runs, "K6": k6_runs}
    assert k6.launch_count() == k5.launch_count() == k1.plain_count() == 0
    assert tuple(y.shape) == ref.shape == (2, 6, 6, 256)
    for want in (ref, wave):
        err, tol = fp32_error(y, want)
        assert err <= tol, (err, tol)
    sess.run_batch(torch.as_tensor(x))
    assert sess.compile_count == 1 and k6.plain_count() == 2 * k6_runs
    h = sess.health()
    assert h["launches_per_forward"] == k6_runs + k5_runs
    assert h["counters"]["plain_calls_conv_stream"] == 2 * k6_runs
    assert h["counters"]["plain_calls_fused_conv_pool"] == 2 * k5_runs
    assert f"pool_backend={pool_backend}" in sess.describe()
    assert f"'K6': {k6_runs}" in sess.describe()


def residual_block(pkg_graph, pkg_dec):
    """A stem conv with a 2/2 pool, then two convs whose output adds to
    the stem's (a ResNet identity block), in one package's classes."""
    def conv(name, ci, co, hw, inputs, relu=True, pool=1):
        return pkg_graph.GraphNode(
            name, "conv", inputs,
            layer=pkg_dec.ConvLayer(name, hw, hw, ci, co, 3, pad=1,
                                    pool=pool, pool_stride=pool),
            relu=relu)
    return pkg_graph.NetworkGraph("block", (16, 16, 3), (
        conv("stem", 3, 8, 16, (pkg_graph.INPUT,), pool=2),
        conv("c1", 8, 8, 8, ("stem",)),
        conv("c2", 8, 8, 8, ("c1",), relu=False),
        pkg_graph.GraphNode("add", "add", ("c2", "stem"), relu=True)),
        "add")


def test_run_graph_streamed_interpret_tracks_peak_like_the_reference():
    from repro.core import decomposition as jdec
    from repro.core import graph as jgraph
    from repro.models.cnn import init_graph_weights as jinit
    from repro_torch.core import decomposition as tdec
    from repro_torch.core import graph as tgraph
    jg, tg = residual_block(jgraph, jdec), residual_block(tgraph, tdec)
    jw = jinit(jg, jax.random.key(6))
    tw = weights_from_numpy(tg, {n: (np.asarray(w), np.asarray(b))
                                 for n, (w, b) in jw.items()}, "cpu")
    x = images(tg, 2, 5)
    # small budgets: several tiles and channel chains per node
    plans = tstream.plan_graph(tg, 2 * 1024)
    jplans = jstream.plan_graph(jg, 2 * 1024)
    assert max(p.tiles_h * p.tiles_w * p.in_splits
               for p in plans.values()) > 1
    for liveness in (True, False):
        jpeak, tpeak = [], []
        want = np.asarray(jstream.run_graph_streamed(
            jg, jplans, jnp.asarray(x), jw, mode="interpret",
            liveness=liveness, track_peak=jpeak))
        got = tstream.run_graph_streamed(
            tg, plans, torch.as_tensor(x), tw, mode="interpret",
            liveness=liveness, track_peak=tpeak)
        err, tol = fp32_error(got, want)
        assert err <= tol
        assert tpeak == jpeak and tpeak[0] > x.nbytes
    # the compiled modes, through the executor cache
    for mode in ("wave", "scan", "megakernel", "graphkernel"):
        got = tstream.run_graph_streamed(tg, plans, torch.as_tensor(x), tw,
                                         mode=mode)
        err, tol = fp32_error(got, want)
        assert err <= tol, mode
    with pytest.raises(ValueError, match="fp32-only"):
        tstream.run_graph_streamed(tg, plans, torch.as_tensor(x), tw,
                                   mode="interpret", precision="int8")


def test_session_mode_and_backend_checks():
    from repro_torch.core import decomposition as tdec
    from repro_torch.core import graph as tgraph
    tg = residual_block(tgraph, tdec)
    with pytest.raises(ValueError, match="interpret"):
        StreamingSession.for_graph(tg, None, device="cpu", mode="interpret")
    with pytest.raises(ValueError, match="conv backend"):
        StreamingSession.for_graph(tg, None, device="cpu", mode="wave",
                                   conv_backend="cudnn")
    with pytest.raises(ValueError, match="pool backend"):
        StreamingSession.for_graph(tg, None, device="cpu", mode="scan",
                                   pool_backend="max")
    with pytest.raises(ValueError, match="interpret"):
        tstream.graph_forward_fn(tg, tstream.compile_graph(
            tg, tstream.plan_graph(tg)), "interpret")


def test_serve_cli_wave_with_fused_pool(capsys):
    serve.main(["--mode", "wave", "--pool-backend", "fused", "--batch", "2",
                "--requests", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    # 3 requests at batch 2: two batched calls, three K5 runs each
    assert "compiles=1, batched calls=2" in out
    assert "K5 0/6" in out and "'K5': 3" in out
    assert "pool_backend=fused" in out
