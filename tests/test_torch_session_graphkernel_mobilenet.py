"""MobileNet-v1 (13 depthwise nodes, the direct body) at 32x32, width 8,
served by the port's ``StreamingSession(mode="graphkernel")`` on the CPU
as one 27-node fused chain, with test_torch_session_graphkernel_zoo.py's
check."""
import pytest

pytest.importorskip("torch")

from test_torch_session_graphkernel_zoo import check_zoo_graph  # noqa: E402


def test_mobilenet_v1_graphkernel_matches_jax_and_megakernel():
    check_zoo_graph("mobilenet_v1", 27)
