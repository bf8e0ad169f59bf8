"""Hand-written CUDA kernels of the port, each beside its plain version."""

from fast_srgan_torch.kernels.fused_upsample import (
    fused_upsample,
    fused_upsample_reference,
)
from fast_srgan_torch.kernels.instance_norm import (
    instance_norm_add,
    instance_norm_add_from_stats,
    instance_norm_add_from_stats_reference,
    instance_norm_add_reference,
    instance_norm_prelu,
    instance_norm_prelu_from_stats,
    instance_norm_prelu_from_stats_reference,
    instance_norm_prelu_reference,
    instance_norm_stats,
    instance_norm_stats_reference,
)
from fast_srgan_torch.kernels.int8_conv import (
    int8_conv,
    int8_conv_phases,
    int8_conv_phases_reference,
    int8_conv_reference,
)
from fast_srgan_torch.kernels.layer_norm import layer_norm, layer_norm_reference
from fast_srgan_torch.kernels.pixel_shuffle import (
    pixel_shuffle_phase_major,
    pixel_shuffle_phase_major_reference,
)
from fast_srgan_torch.kernels.quantize import quantize_act, quantize_act_reference
from fast_srgan_torch.kernels.selective_scan import selective_scan, selective_scan_reference
from fast_srgan_torch.kernels.tail_epilogue import tail_epilogue, tail_epilogue_reference
from fast_srgan_torch.kernels.window_attn import window_attn, window_attn_reference

__all__ = [
    "fused_upsample",
    "fused_upsample_reference",
    "instance_norm_add",
    "instance_norm_add_from_stats",
    "instance_norm_add_from_stats_reference",
    "instance_norm_add_reference",
    "instance_norm_prelu",
    "instance_norm_prelu_from_stats",
    "instance_norm_prelu_from_stats_reference",
    "instance_norm_prelu_reference",
    "instance_norm_stats",
    "instance_norm_stats_reference",
    "int8_conv",
    "int8_conv_phases",
    "int8_conv_phases_reference",
    "int8_conv_reference",
    "layer_norm",
    "layer_norm_reference",
    "pixel_shuffle_phase_major",
    "pixel_shuffle_phase_major_reference",
    "quantize_act",
    "quantize_act_reference",
    "selective_scan",
    "selective_scan_reference",
    "tail_epilogue",
    "tail_epilogue_reference",
    "window_attn",
    "window_attn_reference",
]
