"""int8 quantized matmul (kernel K8): launcher, public wrapper, quantizers
and the plain PyTorch versions of the kernel."""
from repro_torch.kernels.quant_matmul.ops import quant_matmul  # noqa: F401
from repro_torch.kernels.quant_matmul.ref import (  # noqa: F401
    quant_matmul_acc_ref, quant_matmul_ref, quant_matmul_requant_ref)
