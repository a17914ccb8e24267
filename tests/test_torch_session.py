"""The port's ``StreamingSession`` on the CPU (each kernel's plain version)
against the JAX package: AlexNet at 227x227 and full width against
``run_graph_reference`` and the JAX wave-mode session (ResNet-18 and
MobileNet-v1 are in test_torch_session_zoo.py); plus the serving
surface — micro-batching with a padded partial flush, input checks,
deadlines, shedding and the device rule. Weights come from the
JAX package's ``init_graph_weights`` and cross over as numpy arrays.
Tolerance: ``FP32_TOL`` (repro_torch/kernels/wave_replay/ref.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import model_zoo as jzoo  # noqa: E402
from repro.core.streaming import run_graph_reference as jax_reference  # noqa: E402,E501
from repro.launch.session import StreamingSession as JaxSession  # noqa: E402
from repro.models.cnn import init_graph_weights as jax_init  # noqa: E402
from repro_torch.core import decomposition as tdec  # noqa: E402
from repro_torch.core import model_zoo as tzoo  # noqa: E402
from repro_torch.core.graph import chain_graph  # noqa: E402
from repro_torch.kernels.wave_replay import ops  # noqa: E402
from repro_torch.kernels.wave_replay.ref import fp32_error  # noqa: E402
from repro_torch.launch import session as tsession  # noqa: E402
from repro_torch.launch.session import StreamingSession  # noqa: E402
from repro_torch.models.cnn import (apply_graph,  # noqa: E402
                                    init_graph_weights, weights_from_numpy)
from repro_torch.runtime.errors import (DeadlineExceeded,  # noqa: E402
                                        Overloaded)


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


def test_alexnet_227_full_width_matches_jax_reference_and_wave_session():
    jg, jw, tg, tw = pair("alexnet")
    x = images(tg, 2, 0)
    sess = StreamingSession.for_graph(tg, tw, max_batch=2, device="cpu")
    ops.reset_launch_count()
    y = sess.run_batch(torch.as_tensor(x))
    assert ops.plain_count() == 5 and ops.launch_count() == 0
    ref = np.asarray(jax_reference(jg, jw, jnp.asarray(x))[jg.output])
    assert y.shape == ref.shape == (2, 6, 6, 256)
    assert np.abs(ref).max() > 1.0            # a non-trivial output
    err, tol = fp32_error(y, ref)
    assert err <= tol, (err, tol)
    wave = JaxSession.for_graph(jg, jw, max_batch=2, mode="wave")
    err, tol = fp32_error(y, np.asarray(wave.run_batch(jnp.asarray(x))))
    assert err <= tol, (err, tol)
    # a second call replays the same forward and tables
    sess.run_batch(torch.as_tensor(x))
    assert ops.plain_count() == 10 and sess.compile_count == 1
    # the port's own reference agrees with the JAX one
    err, tol = fp32_error(apply_graph(tg, tw, torch.as_tensor(x)), ref)
    assert err <= tol


def tiny():
    """A two-layer chain: the serving tests need a graph, not a big one."""
    tg = chain_graph((tdec.ConvLayer("a", 8, 8, 3, 4, 3, pad=1, pool=2),
                      tdec.ConvLayer("b", 4, 4, 4, 6, 3, pad=1)),
                     name="tiny")
    return tg, init_graph_weights(tg, torch.Generator().manual_seed(0),
                                  "cpu")


def small_session(**kw):
    tg, tw = tiny()
    return tg, tw, StreamingSession.for_graph(tg, tw, device="cpu", **kw)


def test_submit_flush_result_with_padded_partial_flush():
    tg, tw, sess = small_session(max_batch=2)
    x = images(tg, 3, 3)
    tickets = [sess.submit(torch.as_tensor(im)) for im in x]
    assert sess.pending == 1                  # the first two auto-flushed
    outs = [sess.result(t) for t in tickets]  # flushes the padded third
    assert sess.pending == 0 and sess.calls == 2
    assert sess.compile_count == 1            # one shape, one lowering
    want = apply_graph(tg, tw, torch.as_tensor(x))
    for i, o in enumerate(outs):
        err, tol = fp32_error(o, want[i])
        assert err <= tol
    with pytest.raises(KeyError):
        sess.result(tickets[0])               # already fetched
    t = sess.submit(torch.as_tensor(x[0]))
    sess.discard(t)
    assert sess.pending == 0
    h = sess.health()
    assert h["counters"]["compiles"] == 1 and h["counters"]["calls"] == 2
    assert h["mode"] == "megakernel" and h["launches_per_forward"] == 2
    assert "compiles=1" in sess.describe()


def test_deadlines_and_shedding():
    now = [0.0]
    _, _, sess = small_session(max_batch=4, max_pending=2,
                               clock=lambda: now[0])
    img = torch.zeros(sess.graph.in_shape)
    late = sess.submit(img, deadline=1.0)
    sess.submit(img)
    with pytest.raises(Overloaded):
        sess.submit(img)
    assert sess.shed == 1
    now[0] = 2.0
    sess.flush()
    assert sess.deadline_expired == 1
    with pytest.raises(DeadlineExceeded):
        sess.result(late)


def test_check_input_rejections_name_the_spec():
    _, _, sess = small_session(max_batch=2)
    H, W, C = sess.graph.in_shape
    with pytest.raises(ValueError, match=rf"\(B, {H}, {W}, {C}\)"):
        sess.run_batch(torch.zeros(2, H + 1, W, C))
    with pytest.raises(ValueError, match="dtype"):
        sess.run_batch(torch.zeros(2, H, W, C, dtype=torch.int32))
    bad = torch.zeros(2, H, W, C)
    bad[0, 0, 0, 0] = float("nan")
    with pytest.raises(ValueError, match="NaN"):
        sess.run_batch(bad)
    with pytest.raises(ValueError, match=rf"\({H}, {W}, {C}\)"):
        sess.submit(torch.zeros(2, H, W, C))


def test_no_device_means_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tg, tw = tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingSession.for_graph(tg, tw)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsession.resolve_device("cuda")
    assert tsession.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("kw", [dict(mode="wave", fallback=True),
                                dict(mode="scan", guard=True),
                                dict(mode="auto"), dict(tracer=True),
                                dict(fallback=True), dict(guard=True)])
def test_unported_options_name_their_roadmap_item(kw):
    tg, tw = tiny()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamingSession.for_graph(tg, tw, device="cpu", **kw)


def test_weights_from_numpy_checks_every_node():
    tg = tzoo.network_graph("facedet")
    np_w = {n.name: (np.zeros((n.layer.kernel, n.layer.kernel,
                               n.layer.in_c // n.layer.groups,
                               n.layer.out_c), np.float32),
                     np.zeros((n.layer.out_c,), np.float32))
            for n in tg.conv_nodes()}
    assert set(weights_from_numpy(tg, np_w, "cpu")) == set(np_w)
    with pytest.raises(ValueError, match="missing"):
        weights_from_numpy(tg, {k: v for k, v in np_w.items()
                                if k != "c1"}, "cpu")
    with pytest.raises(ValueError, match="extra"):
        weights_from_numpy(tg, dict(np_w, bogus=np_w["c1"]), "cpu")
    with pytest.raises(ValueError, match="HWIO"):
        weights_from_numpy(tg, dict(np_w, c1=(np_w["c1"][0].T,
                                              np_w["c1"][1])), "cpu")


def test_init_graph_weights_he_normal_from_a_generator():
    tg = tzoo.network_graph("facedet")
    a = init_graph_weights(tg, torch.Generator().manual_seed(3), "cpu")
    b = init_graph_weights(tg, torch.Generator().manual_seed(3), "cpu")
    for n in tg.conv_nodes():
        l = n.layer
        w, bias = a[n.name]
        assert w.shape == (l.kernel, l.kernel, l.in_c // l.groups, l.out_c)
        assert torch.equal(w, b[n.name][0]) and not bias.any()
