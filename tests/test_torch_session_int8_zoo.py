"""The port's int8 ``StreamingSession`` on ResNet-18 (residual epilogue,
unified add scales) and MobileNet-v1 (depthwise) at reduced size, bit
for bit against the JAX package's int32 reference walk over the same
carried ``QuantizedGraph`` (AlexNet and the serving surface are in
test_torch_session_int8.py; split so test workers share them)."""
import pytest

pytest.importorskip("torch")

from test_torch_session_int8 import check_session_against_jax  # noqa: E402


@pytest.mark.parametrize("name,launches", [("resnet18", 20),
                                           ("mobilenet_v1", 27)])
def test_int8_session_bit_exact_to_jax_int32_reference(name, launches):
    check_session_against_jax(name, launches, in_hw=32, width=8)
