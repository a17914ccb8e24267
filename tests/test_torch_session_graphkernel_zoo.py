"""ResNet-18 (residual adds carried through the arena) at 32x32, width 8,
served by the port's
``StreamingSession(mode="graphkernel")`` on the CPU at batch 8, one fused
chain per forward: the chain partition and tables equal the JAX
package's at both precisions, the fp32 output is within ``FP32_TOL`` of
the JAX reference and equal to the megakernel session's, and the raw
int8 output (the port's own calibration) equals the megakernel
session's and the port's int32 walk, which test_torch_session_int8_zoo.py
holds to the JAX walk. The helpers are test_torch_session_graphkernel.py's;
MobileNet-v1 (depthwise nodes) runs the same check in
test_torch_session_graphkernel_mobilenet.py, so that parallel test
workers share the work.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import streaming as jstream  # noqa: E402
from repro_torch.kernels.wave_replay import graph as k2  # noqa: E402
from repro_torch.kernels.wave_replay import kernel as k1  # noqa: E402
from repro_torch.kernels.wave_replay.ref import fp32_error  # noqa: E402
from repro_torch.kernels.wave_replay_q import graph as k4  # noqa: E402
from repro_torch.quant.accuracy import quant_graph_reference_acts  # noqa: E402,E501
from repro_torch.quant.calibrate import calibrate_graph  # noqa: E402
from test_torch_session_graphkernel import (check_chains_and_tables,  # noqa: E402,E501
                                            pair, reset, sessions)

BATCH = 8


def check_zoo_graph(name, n_convs):
    """One fused chain of ``n_convs`` nodes: the lowering is the
    reference's, the fp32 output the megakernel session's and within
    tolerance of the JAX reference, the raw int8 output the megakernel
    session's and the int32 walk's."""
    check_chains_and_tables(name, [n_convs], BATCH)
    jg, jw, tg, tw, x = pair(name, BATCH)
    sess, mega = sessions(name, BATCH)
    reset()
    y = sess.run_batch(torch.as_tensor(x))
    assert k2.plain_count() == 1 and k1.plain_count() == 0
    assert torch.equal(y, mega.run_batch(torch.as_tensor(x)))
    ref = np.asarray(jstream.run_graph_reference(
        jg, jw, jnp.asarray(x))[jg.output])
    err, tol = fp32_error(y, ref)
    assert err <= tol
    qg = calibrate_graph(tg, tw, torch.as_tensor(x[:2]))
    raw, raw_mega = sessions(name, BATCH, precision="int8", qnet=qg,
                             dequantize=False)
    got = raw.run_batch(torch.as_tensor(x))
    assert k4.plain_count() == 1
    assert torch.equal(got, raw_mega.run_batch(torch.as_tensor(x)))
    walk = quant_graph_reference_acts(qg, torch.as_tensor(x))[tg.output]
    assert torch.equal(got, walk)
    assert np.count_nonzero(got.numpy()) > 0
    assert raw.health()["launches_per_forward"] == 1


def test_resnet18_graphkernel_matches_jax_and_megakernel():
    check_zoo_graph("resnet18", 20)
