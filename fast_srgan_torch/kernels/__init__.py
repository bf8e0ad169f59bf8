"""Hand-written CUDA kernels of the port, each beside its plain version."""

from fast_srgan_torch.kernels.instance_norm import (
    instance_norm_prelu,
    instance_norm_prelu_reference,
)

__all__ = ["instance_norm_prelu", "instance_norm_prelu_reference"]
