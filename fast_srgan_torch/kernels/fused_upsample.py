"""Fused upsample stage: 3x3 conv + bias + PixelShuffle(2) + PReLU.

The port of ``fast_srgan_tpu/kernels/fused_upsample.py`` (its v1, v2 and
v3 Pallas kernels are one function; ``csrc/fused_upsample.cu`` computes it
in one implicit-GEMM kernel for every H and W). The kernel reads the input
once and writes the shuffled 2x-resolution output once: the [B, 4C, H, W]
conv output is never stored.

``fused_upsample`` is an autograd Function. Its forward takes the plain
version on a CPU tensor and launches the kernel on a CUDA tensor (or raises
``ValueError`` for what the kernel does not take). Its backward
differentiates the plain composition, as the JAX ``_fused_bwd`` does; there
is no backward kernel. Autocast is off inside: the activation's dtype is
the compute dtype, and weight, bias and slope are cast to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fast_srgan_torch.kernels.pixel_shuffle import phase_major_index

#: Input channels the kernel is built for (the generator's n_filters).
C_IN = 64
_DTYPES = (torch.bfloat16, torch.float32)


def fused_upsample_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """Plain version, the JAX ``_reference_impl``: conv with the weight cast
    to x's dtype, + bias cast to x's dtype, ``F.pixel_shuffle(., 2)``, then
    PReLU with the slope cast to x's dtype. weight [4C, Cin, 3, 3] in torch
    channel order, bias [4C], alpha one value."""
    y = F.conv2d(x, weight.to(x.dtype), padding=1)
    y = F.pixel_shuffle(y + bias.to(x.dtype).view(1, -1, 1, 1), 2)
    a = alpha.to(y.dtype)
    return torch.where(y >= 0, y, a * y)


def check_kernel_inputs(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor
) -> None:
    """Raise ValueError unless the CUDA kernel takes these tensors as they are."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_upsample takes bf16 or fp32, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] != C_IN:
        raise ValueError(
            f"x must be [B, {C_IN}, H, W] (the kernel is built for C_in={C_IN}),"
            f" got shape {tuple(x.shape)}"
        )
    c4 = weight.shape[0]
    if tuple(weight.shape) != (c4, C_IN, 3, 3) or c4 % 64:
        raise ValueError(
            f"weight must be [4C, {C_IN}, 3, 3] with C % 16 == 0, got "
            f"{tuple(weight.shape)}"
        )
    if tuple(bias.shape) != (c4,) or alpha.numel() != 1:
        raise ValueError("bias must be [4C] and alpha one value")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be contiguous in torch.channels_last")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    b, _, h, w = x.shape
    if b > 65535 or b * h * w == 0 or b * h * w * c4 >= 2**31:
        raise ValueError(f"unsupported size {tuple(x.shape)} -> 4C={c4}")
    if any(t.device != x.device for t in (weight, bias, alpha)):
        raise ValueError("weight, bias and alpha must be on x's device")


def _launch(x, weight, bias, alpha) -> torch.Tensor:
    from fast_srgan_torch.kernels._build import load_library

    check_kernel_inputs(x, weight, bias, alpha)
    lib = load_library()
    b, _, h, w = x.shape
    c4 = weight.shape[0]
    with torch.cuda.device(x.device):
        perm = phase_major_index(c4, x.device)
        # [4C, Cin, 3, 3] torch order -> [3, 3, Cin, 4C] phase-major = [9, Cin, 4C]
        wk = weight.detach().to(x.dtype)[perm].permute(2, 3, 1, 0).contiguous()
        bk = bias.detach().to(x.dtype)[perm].float().contiguous()
        ak = alpha.detach().reshape(1).to(x.dtype).float().contiguous()
        out = torch.empty(
            (b, c4 // 4, 2 * h, 2 * w), dtype=x.dtype, device=x.device,
            memory_format=torch.channels_last,
        )
        fn = (
            lib.fsr_fused_upsample_bf16 if x.dtype == torch.bfloat16
            else lib.fsr_fused_upsample_f32
        )
        err = fn(
            x.data_ptr(), wk.data_ptr(), bk.data_ptr(), ak.data_ptr(),
            out.data_ptr(), b, h, w, c4 // 4,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"fused_upsample launch failed: cudaError {err}")
    fused_upsample.launches += 1
    return out


class FusedUpsampleFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, alpha):
        ctx.save_for_backward(x, weight, bias, alpha)
        if x.device.type == "cpu":
            with torch.autocast("cpu", enabled=False):
                return fused_upsample_reference(x, weight, bias, alpha)
        if x.device.type != "cuda":
            raise ValueError(f"fused_upsample runs on cpu or cuda, not {x.device}")
        return _launch(x, weight, bias, alpha)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad(), torch.autocast(grad.device.type, enabled=False):
            y = fused_upsample_reference(*inputs)
        return torch.autograd.grad(y, inputs, grad)


def fused_upsample(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """One upsample stage of [B, 64, H, W] x -> [B, C, 2H, 2W], computed in
    x's dtype with fp32 accumulation. weight [4C, 64, 3, 3] torch channel
    order, bias [4C], alpha (1,): ``UpSamplingBlock``'s own parameters.

    ``fused_upsample.launches`` counts the calls that launched the kernel."""
    return FusedUpsampleFunction.apply(x, weight, bias, alpha)


fused_upsample.launches = 0
