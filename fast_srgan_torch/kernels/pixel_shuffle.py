"""PixelShuffle(2) of phase-major channels: the CUDA kernel and its plain version.

The port of ``fast_srgan_tpu/kernels/pixel_shuffle.py``. When the 4C input
channels are in phase-major order ``ch' = (2i + j) * C + c`` (rather than
torch's ``c * 4 + 2i + j``), the shuffle is a pure copy on channels_last
memory: output pixel (2h+i, 2w+j) takes input pixel (h, w)'s channel block
``(2i + j)``. ``csrc/pixel_shuffle.cu`` does that copy in 16-byte vectors;
the result is bitwise equal to the plain version.

The unfused upsample stage (``models/generator.py``) runs its conv with
phase-major weights and shuffles through this op, so the permutation
gathers the weights, not the activation. The op is
``fast_srgan::pixel_shuffle_phase_major`` (``torch.library``; opaque to
``torch.export``). Dispatch follows the tensor, as in
``kernels/instance_norm.py``: its CPU implementation is the plain version;
its CUDA one launches the kernel or raises ``ValueError``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def phase_major_permutation(c4: int) -> np.ndarray:
    """perm such that K[..., perm] orders output channels (i, j, c)-major
    from torch's (c, i, j)-major (ch = c*4 + 2i + j)."""
    c = c4 // 4
    perm = np.empty(c4, np.int64)
    for i in range(2):
        for j in range(2):
            for ch in range(c):
                perm[i * 2 * c + j * c + ch] = ch * 4 + 2 * i + j
    return perm


@functools.lru_cache(maxsize=64)
def phase_major_index(c4: int, device: torch.device, inverse: bool = False) -> torch.Tensor:
    """The permutation (or its inverse) as an index tensor on ``device``,
    made once: a host-to-device copy per call would stall the host. Made
    outside inference mode, so a first call under ``torch.inference_mode``
    does not cache a tensor that autograd then refuses."""
    perm = phase_major_permutation(c4)
    with torch.inference_mode(False):
        return torch.from_numpy(np.argsort(perm) if inverse else perm).to(device)


def pixel_shuffle_phase_major_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: back to torch channel order, then ``F.pixel_shuffle``.
    [B, 4C, H, W] phase-major -> [B, C, 2H, 2W] channels_last."""
    y = F.pixel_shuffle(x[:, phase_major_index(x.shape[1], x.device, inverse=True)], 2)
    return y.contiguous(memory_format=torch.channels_last)


def check_kernel_inputs(x: torch.Tensor) -> None:
    """Raise ValueError unless the CUDA kernel takes x as it is."""
    if x.dim() != 4 or x.shape[1] % 4:
        raise ValueError(f"x must be [B, 4C, H, W], got shape {tuple(x.shape)}")
    b, c4, h, w = x.shape
    c_bytes = c4 // 4 * x.element_size()
    if c_bytes % 16:
        raise ValueError(
            f"C={c4 // 4} of {x.dtype} is {c_bytes} bytes: need a multiple of 16"
        )
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be contiguous in torch.channels_last")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if b * h * w == 0 or x.numel() * x.element_size() // 16 >= 2**31:
        raise ValueError(f"unsupported size {tuple(x.shape)}")


def _launch(x: torch.Tensor) -> torch.Tensor:
    from fast_srgan_torch.kernels._build import load_library

    check_kernel_inputs(x)
    lib = load_library()
    b, c4, h, w = x.shape
    with torch.cuda.device(x.device):
        out = torch.empty(
            (b, c4 // 4, 2 * h, 2 * w), dtype=x.dtype, device=x.device,
            memory_format=torch.channels_last,
        )
        err = lib.fsr_pixel_shuffle_phase_major(
            x.data_ptr(), out.data_ptr(), b, h, w, c4 // 4 * x.element_size(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"pixel_shuffle_phase_major launch failed: cudaError {err}")
    pixel_shuffle_phase_major.launches += 1
    return out


def _fake(x):
    b, c4, h, w = x.shape
    return x.new_empty((b, c4 // 4, 2 * h, 2 * w)).contiguous(memory_format=torch.channels_last)


_LIB = torch.library.Library("fast_srgan", "FRAGMENT")
_LIB.define("pixel_shuffle_phase_major(Tensor x) -> Tensor")
_LIB.impl("pixel_shuffle_phase_major", pixel_shuffle_phase_major_reference, "CPU")
_LIB.impl("pixel_shuffle_phase_major", _launch, "CUDA")
torch.library.register_fake("fast_srgan::pixel_shuffle_phase_major", _fake, lib=_LIB)
_OP = torch.ops.fast_srgan.pixel_shuffle_phase_major.default


class PixelShufflePhaseMajorFunction(torch.autograd.Function):
    """Forward through the op; the backward of a copy is the inverse copy,
    one pass on channels_last memory: grad pixel (2h+i, 2w+j) channel c
    goes to pixel (h, w) channel (2i + j) * C + c."""

    @staticmethod
    def forward(ctx, x):
        return _OP(x)

    @staticmethod
    def backward(ctx, grad):
        b, c, h2, w2 = grad.shape
        g = grad.permute(0, 2, 3, 1).reshape(b, h2 // 2, 2, w2 // 2, 2, c)
        g = g.permute(0, 1, 3, 2, 4, 5).reshape(b, h2 // 2, w2 // 2, 4 * c)
        return g.permute(0, 3, 1, 2)


def pixel_shuffle_phase_major(x: torch.Tensor) -> torch.Tensor:
    """PixelShuffle(2) of [B, 4C, H, W] phase-major x -> [B, C, 2H, 2W].

    ``pixel_shuffle_phase_major.launches`` counts the calls that launched
    the CUDA kernel."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pixel_shuffle_phase_major runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        return PixelShufflePhaseMajorFunction.apply(x)
    return _OP(x)


pixel_shuffle_phase_major.launches = 0


def fast_pixel_shuffle_from_torch_order(x: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``F.pixel_shuffle(x, 2)`` on torch-ordered channels:
    permute them to phase-major, then shuffle (one extra copy; permuting a
    conv's weights instead avoids it)."""
    xp = x[:, phase_major_index(x.shape[1], x.device)]
    return pixel_shuffle_phase_major(xp.contiguous(memory_format=torch.channels_last))
