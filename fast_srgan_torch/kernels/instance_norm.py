"""Fused instance norm + PReLU: the CUDA kernel and its plain version.

The port of ``fast_srgan_tpu/kernels/instance_norm.py``. The residual stem
runs ``conv1 -> InstanceNorm -> PReLU`` in each of its blocks; this op does
the norm and the PReLU in one kernel family (``csrc/instance_norm.cu``): a
statistics pass and a normalize pass over a tiled grid, bandwidth-bound,
two reads and one write of the activation.

Dispatch follows the tensor: a CPU tensor takes
:func:`instance_norm_prelu_reference` (the plain composition, the numerical
contract); a CUDA tensor launches the kernel or raises ``ValueError`` for
what the kernel does not take. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from fast_srgan_torch.ops.norm import EPS, instance_norm

#: Pixels per tile of the kernel's grid (gridDim.x = ceil(H*W / TILE_PX)).
TILE_PX = 1024
# 16-byte vectors: values per load, and the most channel groups a block takes.
_VEC = {torch.bfloat16: 8, torch.float32: 4}
_MAX_GROUPS = 256


def instance_norm_prelu_reference(
    x: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """Plain composition: ``ops.norm.instance_norm`` then a PReLU whose
    slope is cast to the activation dtype (the JAX ``_reference_impl``)."""
    y = instance_norm(x, eps=EPS)
    a = alpha.to(y.dtype)
    return torch.where(y >= 0, y, a * y)


def check_kernel_inputs(x: torch.Tensor, alpha: torch.Tensor) -> None:
    """Raise ValueError unless the CUDA kernel takes (x, alpha) as they are."""
    if x.dtype not in _VEC:
        raise ValueError(f"instance_norm_prelu takes bf16 or fp32, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got shape {tuple(x.shape)}")
    b, c, h, w = x.shape
    vec = _VEC[x.dtype]
    if c % vec or c // vec > _MAX_GROUPS:
        raise ValueError(
            f"C={c} unsupported for {x.dtype}: need C % {vec} == 0 and "
            f"C <= {vec * _MAX_GROUPS}"
        )
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be contiguous in torch.channels_last")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if b > 65535 or b * h * w * c >= 2**31 or b * h * w == 0:
        raise ValueError(f"unsupported size {tuple(x.shape)}")
    if alpha.numel() != 1 or alpha.device != x.device:
        raise ValueError("alpha must be one value on x's device")


def _launch(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    from fast_srgan_torch.kernels._build import load_library

    check_kernel_inputs(x, alpha)
    lib = load_library()
    b, c, h, w = x.shape
    hw = h * w
    tiles = (hw + TILE_PX - 1) // TILE_PX
    with torch.cuda.device(x.device):
        out = torch.empty_like(x, memory_format=torch.channels_last)
        partial = torch.empty(
            (b, tiles, 2, c), dtype=torch.float32, device=x.device
        )
        a32 = alpha.detach().reshape(1).to(torch.float32).contiguous()
        fn = (
            lib.fsr_instance_norm_prelu_bf16 if x.dtype == torch.bfloat16
            else lib.fsr_instance_norm_prelu_f32
        )
        err = fn(
            x.data_ptr(), a32.data_ptr(), out.data_ptr(), partial.data_ptr(),
            b, hw, c, TILE_PX, EPS,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"instance_norm_prelu launch failed: cudaError {err}")
    instance_norm_prelu.launches += 1
    return out


def _forward(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return instance_norm_prelu_reference(x, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_prelu runs on cpu or cuda, not {x.device}")
    return _launch(x, alpha)


class InstanceNormPReLUFunction(torch.autograd.Function):
    """Forward through the kernel; backward differentiates the plain
    composition (the JAX package's ``_bwd`` does the same)."""

    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x, alpha)
        return _forward(x, alpha)

    @staticmethod
    def backward(ctx, grad):
        x, alpha = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            ad = alpha.detach().requires_grad_(True)
            y = instance_norm_prelu_reference(xd, ad)
        gx, ga = torch.autograd.grad(y, (xd, ad), grad)
        return gx, ga


def instance_norm_prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Fused IN + PReLU of [B, C, H, W] x with a one-value slope.

    ``instance_norm_prelu.launches`` counts the calls that launched the
    CUDA kernel (one per call: the statistics and normalize kernels)."""
    return InstanceNormPReLUFunction.apply(x, alpha)


instance_norm_prelu.launches = 0
