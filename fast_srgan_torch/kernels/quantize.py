"""Activation quantization to int8: the CUDA kernel and its plain version.

The port of ``fast_srgan_tpu/quant.py:_quantize_act`` (XLA's elementwise
code on the TPU; ``csrc/quantize.cu`` on the card):

    q = clip(round(float(x) * (127 / s)), -127, 127) as int8

with the reciprocal formed first, then the product, and round half to
even. The kernel is bitwise equal to the plain version. The output keeps
the input's memory order (a channels_last activation gives a channels_last
int8 tensor).

The ``torch.library`` op ``fast_srgan::quantize_act`` (opaque to
``torch.export``) dispatches on the tensor: its CPU implementation is
:func:`quantize_act_reference`; its CUDA one launches the kernel or raises
``ValueError`` for what the kernel does not take. There is no fallback
between the two.
"""

from __future__ import annotations

import math
from typing import Sequence

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


def check_size(shape: Sequence[int]) -> None:
    """Raise ValueError unless the kernel's grid takes a tensor of this
    shape: any nonempty one. The kernel's count and offsets are 64-bit and
    its grid-stride loop runs on at most 132 x 32 blocks, so 2^31 elements
    or more are taken (the 4x int8 head's 1024-channel input at batch 37 or
    more of 180x320)."""
    if math.prod(shape) == 0:
        raise ValueError(f"unsupported size {tuple(shape)}")


def check_kernel_inputs(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise ValueError unless the CUDA kernel takes (x, scale) as they are."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize_act takes bf16 or fp32, got {x.dtype}")
    if not _dense(x):
        raise ValueError("x must be contiguous (NCHW or channels_last)")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    check_size(x.shape)
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


def _fake(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, dtype=torch.int8)


_LIB = torch.library.Library("fast_srgan", "FRAGMENT")
_LIB.define("quantize_act(Tensor x, Tensor scale) -> Tensor")
_LIB.impl("quantize_act", quantize_act_reference, "CPU")
_LIB.impl("quantize_act", _launch, "CUDA")
torch.library.register_fake("fast_srgan::quantize_act", _fake, lib=_LIB)
_OP = torch.ops.fast_srgan.quantize_act.default


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 of ``x`` at the per-tensor scale ``scale`` (a one-value tensor).

    ``quantize_act.launches`` counts the calls that launched the kernel."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantize_act runs on cpu or cuda, not {x.device}")
    return _OP(x, scale)


quantize_act.launches = 0
