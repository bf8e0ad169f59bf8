"""Activation quantization to int8: the CUDA kernel and its plain version.

The port of ``fast_srgan_tpu/quant.py:_quantize_act`` (XLA's elementwise
code on the TPU; ``csrc/quantize.cu`` on the card):

    q = clip(round(float(x) * (127 / s)), -127, 127) as int8

with the reciprocal formed first, then the product, and round half to
even. The kernel is bitwise equal to the plain version. The output keeps
the input's memory order (a channels_last activation gives a channels_last
int8 tensor).

Dispatch follows the tensor: a CPU tensor takes :func:`quantize_act_reference`;
a CUDA tensor launches the kernel or raises ``ValueError`` for what the
kernel does not take. There is no fallback between the two.
"""

from __future__ import annotations

import torch

_DTYPES = (torch.bfloat16, torch.float32)


def quantize_reciprocal(scale: torch.Tensor) -> torch.Tensor:
    """``127 / s`` in fp32 as one IEEE division, JAX's rounding: ``127.0 /
    s`` is torch's __rtruediv__, reciprocal(s) * 127, which differs for about
    a quarter of scales. The kernels take this value as it is."""
    s = scale.to(torch.float32)
    return torch.full_like(s, 127.0) / s


def quantize_act_reference(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x`` any float dtype, ``scale`` one fp32 value."""
    r = quantize_reciprocal(scale)
    return torch.round(x.to(torch.float32) * r).clamp_(-127, 127).to(torch.int8)


def _dense(x: torch.Tensor) -> bool:
    return x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)


def check_kernel_inputs(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise ValueError unless the CUDA kernel takes (x, scale) as they are."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize_act takes bf16 or fp32, got {x.dtype}")
    if not _dense(x):
        raise ValueError("x must be contiguous (NCHW or channels_last)")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if x.numel() == 0 or x.numel() >= 2**31:
        raise ValueError(f"unsupported size {tuple(x.shape)}")
    if scale.numel() != 1 or scale.device != x.device:
        raise ValueError("scale must be one value on x's device")


def _launch(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    from fast_srgan_torch.kernels._build import load_library

    check_kernel_inputs(x, scale)
    lib = load_library()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x, dtype=torch.int8)  # the same strides as x
        s32 = scale.detach().reshape(1).to(torch.float32).contiguous()
        fn = lib.fsr_quantize_bf16 if x.dtype == torch.bfloat16 else lib.fsr_quantize_f32
        err = fn(
            x.data_ptr(), s32.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"quantize_act launch failed: cudaError {err}")
    quantize_act.launches += 1
    return out


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 of ``x`` at the per-tensor scale ``scale`` (a one-value tensor).

    ``quantize_act.launches`` counts the calls that launched the kernel."""
    if x.device.type == "cpu":
        return quantize_act_reference(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_act runs on cpu or cuda, not {x.device}")
    return _launch(x, scale)


quantize_act.launches = 0
