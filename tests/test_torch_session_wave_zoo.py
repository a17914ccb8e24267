"""The port's ``StreamingSession`` in wave mode on a ResNet-18
(``in_hw=32``, ``width=8``), whose residual adds run as explicit ops, on
the CPU (each kernel's plain version) against the JAX wave-mode session
and ``run_graph_reference`` on the same numpy inputs, with the direct
conv and with the K6 / K5 plain versions (``conv_backend="pallas"``,
``pool_backend="fused"``), their runs counted per forward. Weights come
from the JAX package's ``init_graph_weights`` and cross over as numpy
arrays. Tolerance: ``FP32_TOL`` (repro_torch/kernels/wave_replay/ref.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import streaming as jstream  # noqa: E402
from repro.launch.session import StreamingSession as JaxSession  # noqa: E402
from repro_torch.kernels.conv_stream import kernel as k6  # noqa: E402
from repro_torch.kernels.fused_conv_pool import kernel as k5  # noqa: E402
from repro_torch.kernels.wave_replay.ref import fp32_error  # noqa: E402
from repro_torch.launch.session import StreamingSession  # noqa: E402
from test_torch_session_wave import images, pair, reset_counts  # noqa: E402,E501


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small ops: one intra-op thread per process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resnet18_wave_session_with_explicit_residual_adds():
    jg, jw, tg, tw = pair("resnet18", in_hw=32, width=8)
    x = images(tg, 2, 4)
    ref = np.asarray(jstream.run_graph_reference(jg, jw, jnp.asarray(x))
                     [jg.output])
    wave = np.asarray(JaxSession.for_graph(jg, jw, max_batch=2, mode="wave")
                      .run_batch(jnp.asarray(x)))
    assert any(n.op == "add" for n in tg.nodes)
    for cb, pb in (("xla", "xla"), ("pallas", "fused")):
        sess = StreamingSession.for_graph(tg, tw, max_batch=2, device="cpu",
                                          mode="wave", conv_backend=cb,
                                          pool_backend=pb)
        reset_counts()
        y = sess.run_batch(torch.as_tensor(x))
        by_kernel = sess.health()["launches_per_forward_by_kernel"]
        assert (k6.plain_count(), k5.plain_count()) == \
            (by_kernel["K6"], by_kernel["K5"])
        for want in (ref, wave):
            err, tol = fp32_error(y, want)
            assert err <= tol, (cb, pb, err, tol)
