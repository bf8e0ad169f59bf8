"""Fused upsample stage: 3x3 conv + bias + PixelShuffle(2) + PReLU.

The port of ``fast_srgan_tpu/kernels/fused_upsample.py`` (its v1, v2 and
v3 Pallas kernels are one function; ``csrc/fused_upsample.cu`` computes it
in one implicit-GEMM kernel for every H and W). The kernel reads the input
once and writes the shuffled 2x-resolution output once: the [B, 4C, H, W]
conv output is never stored.

The stage is the ``torch.library`` op ``fast_srgan::fused_upsample(x,
weight, bias, alpha, prelu=True)`` (opaque to ``torch.export``): its CPU
implementation is the plain version, its CUDA one launches the kernel (or
raises ``ValueError`` for what the kernel does not take). ``prelu=False``
is the pre-activation z = shuffle(conv(x) + b). ``fused_upsample`` calls
the op through an autograd Function where a gradient is recorded. Its
backward recomputes only z (the op with ``prelu=False``), takes the
PReLU's gradients from z, and leaves dx, dW and db to the library's conv
backward, as the JAX ``_fused_bwd`` leaves them to ``jax.vjp`` of the lax
composition. Autocast is off inside: the activation's dtype is the compute
dtype, and weight, bias and slope are cast to it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from fast_srgan_torch.kernels.batching import GRID_YZ_MAX
from fast_srgan_torch.kernels.pixel_shuffle import phase_major_permutation

#: Input channels the kernel is built for (the generator's n_filters).
C_IN = 64
_DTYPES = (torch.bfloat16, torch.float32)


def upsample_preact_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain pre-activation: conv with the weight cast to x's dtype, + bias
    cast to x's dtype, then ``F.pixel_shuffle(., 2)``."""
    y = F.conv2d(x, weight.to(x.dtype), padding=1)
    return F.pixel_shuffle(y + bias.to(x.dtype).view(1, -1, 1, 1), 2)


def fused_upsample_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """Plain version, the JAX ``_reference_impl``: the pre-activation above,
    then PReLU with the slope cast to x's dtype. weight [4C, Cin, 3, 3] in
    torch channel order, bias [4C], alpha one value."""
    y = upsample_preact_reference(x, weight, bias)
    a = alpha.to(y.dtype)
    return torch.where(y >= 0, y, a * y)


def n_tile(c4: int) -> int:
    """Output channels a block of the bf16 kernel keeps resident."""
    return 128 if c4 % 128 == 0 else 64


def _tile_column_channels(nt: int) -> np.ndarray:
    """Phase-major channel (within its N tile) of each column of a tile.

    The wgmma accumulator gives thread t of a quad columns 8j + 2t + e; the
    kernel's epilogue wants 8 consecutive channels in one thread (one
    16-byte store). So within each group of 32 columns, column
    8 jj + 2 t + e holds channel 8 t + 2 jj + e."""
    col = np.arange(nt)
    return 32 * (col // 32) + 8 * ((col % 8) // 2) + 2 * ((col % 32) // 8) + col % 2


@functools.lru_cache(maxsize=32)
def weight_index(c4: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Flat indices into a [4C, 64, 3, 3] weight (torch order) that gather
    it into the kernel's layout, made once per shape and device.

    bf16: [4C / NT][9 taps][4 steps][2][NT][8], element (tile, tap, s, kc,
    col, e) = W[perm[tile * NT + chan(col)], 16 s + 8 kc + e, tap // 3,
    tap % 3], with perm the phase-major permutation: each (tap, 16-channel
    step) slice is wgmma's no-swizzle K-major core-matrix layout.
    fp32: [9][64][4C], element (tap, k, n) = W[perm[n], k, tap // 3, tap % 3]."""
    perm = phase_major_permutation(c4)
    tap = np.arange(9)
    ky, kx = tap // 3, tap % 3
    if dtype == torch.bfloat16:
        nt = n_tile(c4)
        o = perm[np.arange(c4 // nt)[:, None] * nt + _tile_column_channels(nt)[None, :]]
        k = (16 * np.arange(4)[:, None, None] + 8 * np.arange(2)[None, :, None]
             + np.arange(8)[None, None, :])  # [4, 2, 8]
        idx = (((o[:, None, None, None, :, None] * C_IN
                 + k[None, None, :, :, None, :]) * 3
                + ky[None, :, None, None, None, None]) * 3
               + kx[None, :, None, None, None, None])
    else:
        k = np.arange(C_IN)
        idx = ((perm[None, None, :] * C_IN + k[None, :, None]) * 3
               + ky[:, None, None]) * 3 + kx[:, None, None]
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(idx).reshape(-1)).to(device)


def tile_weights(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's weight: ``weight`` [4C, 64, 3, 3] gathered into its
    layout (``weight_index``) and cast to ``dtype``; one gather, one cast."""
    idx = weight_index(weight.shape[0], dtype, weight.device)
    return torch.take(weight.detach(), idx).to(dtype)


def size_takes(shape, c4: int) -> bool:
    """True where the kernel's launch takes an x of ``shape`` [B, 64, H, W]
    and 4C output channels: at most 65535 samples (the fp32 form's
    ``blockIdx.z``), B x H x W x 4C below 2^31, and not empty."""
    b, _, h, w = shape
    return 0 < b * h * w and b <= GRID_YZ_MAX and b * h * w * c4 < 2**31


def kernel_takes(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """True exactly when the CUDA kernel takes these shapes and this dtype:
    x [B, 64, H, W] in bf16 or fp32, weight [4C, 64, 3, 3] with 4C a
    multiple of 64, and a size the launch takes (:func:`size_takes`). Reads
    shapes and dtypes only, so it answers on any device; ``UpSamplingBlock``
    sends every other stage to the unfused form, as the JAX
    ``fused_upsample`` sends it to its lax composition."""
    c4 = weight.shape[0]
    return (
        x.dtype in _DTYPES and x.dim() == 4 and x.shape[1] == C_IN
        and tuple(weight.shape) == (c4, C_IN, 3, 3) and c4 % 64 == 0
        and size_takes(x.shape, c4)
    )


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
    if not size_takes(x.shape, c4):
        raise ValueError(f"unsupported size {tuple(x.shape)} -> 4C={c4}")
    if any(t.device != x.device for t in (weight, bias, alpha)):
        raise ValueError("weight, bias and alpha must be on x's device")


def prepare(weight, bias, alpha, dtype: torch.dtype) -> tuple:
    """The kernel's parameters in ``dtype``: the weight in its layout
    (``tile_weights``), the bias in torch channel order and the slope. Made
    per call, since training changes them every step: four launches at
    most (the weight's gather and cast, the bias's and the slope's casts,
    each cast only where the dtype differs)."""
    return (tile_weights(weight, dtype), bias.detach().to(dtype).contiguous(),
            alpha.detach().reshape(1).to(dtype))


def launch_prepared(x: torch.Tensor, params: tuple, prelu: bool = True) -> torch.Tensor:
    """The kernel alone, on parameters from ``prepare``: PReLU(shuffle(conv
    + bias)), or with ``prelu=False`` the pre-activation shuffle(conv +
    bias), [B, C, 2H, 2W] channels_last. The caller has checked x."""
    from fast_srgan_torch.kernels._build import load_library

    lib = load_library()
    wk, bk, ak = params
    b, _, h, w = x.shape
    c4 = bk.numel()
    with torch.cuda.device(x.device):
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
            out.data_ptr(), b, h, w, c4 // 4, int(prelu),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"fused_upsample launch failed: cudaError {err}")
    if prelu:
        fused_upsample.launches += 1
    else:
        fused_upsample.backward_launches += 1
    return out


def _launch(x, weight, bias, alpha, prelu: bool = True) -> torch.Tensor:
    check_kernel_inputs(x, weight, bias, alpha)
    with torch.cuda.device(x.device):
        params = prepare(weight, bias, alpha, x.dtype)
    return launch_prepared(x, params, prelu)


def _plain(x, weight, bias, alpha, prelu: bool = True) -> torch.Tensor:
    with torch.autocast("cpu", enabled=False):
        if prelu:
            return fused_upsample_reference(x, weight, bias, alpha)
        return upsample_preact_reference(x, weight, bias)


def _fake(x, weight, bias, alpha, prelu: bool = True) -> torch.Tensor:
    b, _, h, w = x.shape
    # the kernel writes channels_last; so does the plain version on a
    # channels_last x (F.pixel_shuffle keeps x's layout)
    cl = x.is_contiguous(memory_format=torch.channels_last)
    y = x.new_empty((b, weight.shape[0] // 4, 2 * h, 2 * w))
    return y.contiguous(memory_format=torch.channels_last if cl else torch.contiguous_format)


_LIB = torch.library.Library("fast_srgan", "FRAGMENT")
_LIB.define("fused_upsample(Tensor x, Tensor weight, Tensor bias, Tensor alpha,"
            " bool prelu=True) -> Tensor")
_LIB.impl("fused_upsample", _plain, "CPU")
_LIB.impl("fused_upsample", _launch, "CUDA")
torch.library.register_fake("fast_srgan::fused_upsample", _fake, lib=_LIB)
_OP = torch.ops.fast_srgan.fused_upsample.default


@register_flop_formula(torch.ops.fast_srgan.fused_upsample)
def _flops(x, weight, *args, **kwargs) -> int:
    """FlopCounterMode's count: the conv's 2 * 9 * Cin * 4C an input pixel,
    as the counter counts aten's convolutions (shapes arrive for tensors)."""
    b, _, h, w = x
    return 2 * weight[0] * weight[1] * weight[2] * weight[3] * b * h * w


class FusedUpsampleFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, alpha):
        ctx.save_for_backward(x, weight, bias, alpha)
        return _OP(x, weight, bias, alpha)

    @staticmethod
    def backward(ctx, grad):
        """From the pre-activation z: dz = where(z >= 0, g, a g) and dalpha =
        sum where(z < 0, g z, 0), as jax.vjp of ``jnp.where(y >= 0, y, a *
        y)`` gives them; then the steps autograd takes through the plain
        composition: ``F.pixel_unshuffle``, db the sum of the result, dx and
        dW from the library's conv backward. All in x's dtype; each gradient
        in its input's dtype."""
        x, weight, bias, alpha = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with torch.autocast(grad.device.type, enabled=False):
            z = _OP(x, weight, bias, alpha, False)
            g = grad.to(z.dtype)
            neg = z < 0
            dy = F.pixel_unshuffle(torch.where(neg, alpha.to(z.dtype) * g, g), 2)
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dy, x, weight.to(z.dtype), None, [1, 1], [1, 1], [1, 1], False,
                [0, 0], 1, [needs[0], needs[1], False],
            )
            return (
                dx if needs[0] else None,
                dw.to(weight.dtype) if needs[1] else None,
                dy.sum((0, 2, 3)).to(bias.dtype) if needs[2] else None,
                torch.where(neg, g * z, 0).sum().reshape(alpha.shape).to(alpha.dtype)
                if needs[3] else None,
            )


def fused_upsample(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor,
    prelu: bool = True,
) -> torch.Tensor:
    """One upsample stage of [B, 64, H, W] x -> [B, C, 2H, 2W], computed in
    x's dtype with fp32 accumulation. weight [4C, 64, 3, 3] torch channel
    order, bias [4C], alpha (1,): ``UpSamplingBlock``'s own parameters.
    ``prelu=False`` returns the pre-activation, the whole stage of a model
    with no activation there (SwinIR's upsampler; ``alpha`` is not read),
    through the plain composition where a gradient is recorded.

    ``fused_upsample.launches`` counts the forwards that launched the
    kernel, ``fused_upsample.backward_launches`` the launches of its
    pre-activation form, the backwards' and the ``prelu=False`` calls' (a
    CUDA graph's capture counts once, its replays not)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_upsample runs on cpu or cuda, not {x.device}")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias, alpha))
    if not prelu:
        if grad:
            return upsample_preact_reference(x, weight, bias)
        return _OP(x, weight, bias, alpha, False)
    if grad:
        return FusedUpsampleFunction.apply(x, weight, bias, alpha)
    return _OP(x, weight, bias, alpha)


fused_upsample.launches = 0
fused_upsample.backward_launches = 0
