"""Hand-written CUDA kernels of the port, each beside its plain version."""

from fast_srgan_torch.kernels.fused_upsample import (
    fused_upsample,
    fused_upsample_reference,
)
from fast_srgan_torch.kernels.instance_norm import (
    instance_norm_prelu,
    instance_norm_prelu_reference,
)
from fast_srgan_torch.kernels.pixel_shuffle import (
    pixel_shuffle_phase_major,
    pixel_shuffle_phase_major_reference,
)

__all__ = [
    "fused_upsample",
    "fused_upsample_reference",
    "instance_norm_prelu",
    "instance_norm_prelu_reference",
    "pixel_shuffle_phase_major",
    "pixel_shuffle_phase_major_reference",
]
