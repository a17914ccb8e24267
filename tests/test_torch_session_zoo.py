"""The port's ``StreamingSession`` on the CPU against the JAX package's
``run_graph_reference`` on ResNet-18 (residual adds fused into the
kernel epilogue, projection shortcuts) and MobileNet-v1 (depthwise
layers), both reduced to 32x32 and width 8. Weights come from the JAX
package's ``init_graph_weights`` as numpy arrays. Tolerance:
``FP32_TOL`` (repro_torch/kernels/wave_replay/ref.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.streaming import run_graph_reference as jax_reference  # noqa: E402,E501
from repro_torch.core.streaming import run_graph_reference  # noqa: E402
from repro_torch.kernels.wave_replay import ops  # noqa: E402
from repro_torch.kernels.wave_replay.ref import fp32_error  # noqa: E402
from repro_torch.launch.session import StreamingSession  # noqa: E402
from test_torch_session import images, pair  # noqa: E402


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v1"])
def test_reduced_graphs_match_jax_reference(name):
    jg, jw, tg, tw = pair(name, in_hw=32, width=8)
    x = images(tg, 2, 1)
    sess = StreamingSession.for_graph(tg, tw, max_batch=2, device="cpu")
    ops.reset_launch_count()
    y = sess.run_batch(x)
    assert ops.plain_count() == len(tg.conv_nodes())
    ref = np.asarray(jax_reference(jg, jw, jnp.asarray(x))[jg.output])
    err, tol = fp32_error(y, ref)
    assert err <= tol, (err, tol)


def test_reference_values_match_jax_at_every_node():
    jg, jw, tg, tw = pair("resnet18", in_hw=32, width=8)
    x = images(tg, 1, 2)
    want = jax_reference(jg, jw, jnp.asarray(x))
    got = run_graph_reference(tg, tw, torch.as_tensor(x))
    assert list(got) == list(want)
    for v in want:
        err, tol = fp32_error(got[v], np.asarray(want[v]))
        assert err <= tol, v
