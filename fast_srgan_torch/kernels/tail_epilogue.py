"""The LR tail's epilogue (bias, PReLU, window): the CUDA kernel and its plain version.

Each upsampling output of the LR-domain tail (``ops/lr_tail.py``: stage 1
and the four stage-2 phases) is a conv computed without its bias, then

    out = prelu(x[:, :, p:p + H, q:q + W] + bias)      (no PReLU: slope None)

with a single shared slope, rounded to the working type after the add and
after the product, as ``add_`` and ``F.prelu`` round: the kernel
(``csrc/tail_epilogue.cu``) is bitwise the plain version in bf16 and fp32.
With ``border`` > 0 the output is zero-padded by ``border`` on every side
in the same pass (stage 1's output, which the phase convs read padded).
Input and output are channels_last.

It replaces no Pallas kernel (XLA fused these ops on the TPU); its bound
is bytes: the window read once and the output written once.

The ``torch.library`` op ``fast_srgan::tail_epilogue`` (opaque to
``torch.export``) dispatches on the tensor: its CPU implementation is
:func:`tail_epilogue_reference`; its CUDA one launches the kernel or
raises ``ValueError`` for what the kernel does not take. There is no
fallback between the two.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

_DTYPES = (torch.bfloat16, torch.float32)
#: threads a block (csrc/tail_epilogue.cu kThreads); each moves 8 channels
#: a step and keeps them for the launch, so C / 8 may not exceed it
_THREADS = 256


def tail_epilogue_reference(
    x: torch.Tensor, bias: torch.Tensor, slope: Optional[torch.Tensor],
    p: int, q: int, h: int, w: int, border: int,
) -> torch.Tensor:
    """Plain version: the window at (p, q) of size h x w of ``x`` [B, C,
    Hin, Win], plus ``bias`` [C], PReLU with the one-value ``slope`` (None:
    none), zero-padded by ``border``; channels_last."""
    check_window(x.shape, p, q, h, w, border)
    v = x[:, :, p:p + h, q:q + w] + bias.view(1, -1, 1, 1)
    if slope is not None:
        v = F.prelu(v, slope)
    if border:
        v = F.pad(v, (border,) * 4)
    return v.contiguous(memory_format=torch.channels_last)


def check_window(shape: Sequence[int], p: int, q: int, h: int, w: int, border: int) -> None:
    """Raise ValueError unless the window lies inside x and the sizes are
    ones the op takes."""
    if len(shape) != 4:
        raise ValueError(f"x must be [B, C, H, W], got shape {tuple(shape)}")
    hin, win = shape[2], shape[3]
    if min(p, q) < 0 or min(h, w) < 1 or p + h > hin or q + w > win:
        raise ValueError(f"window at ({p}, {q}) of {h}x{w} outside x of {hin}x{win}")
    if border < 0:
        raise ValueError(f"border must be >= 0, got {border}")


def check_kernel_inputs(x: torch.Tensor, bias: torch.Tensor, slope: Optional[torch.Tensor],
                        w: int, border: int) -> None:
    """Raise ValueError unless the CUDA kernel takes these tensors as they
    are (the window is :func:`check_window`'s)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"tail_epilogue takes bf16 or fp32, got {x.dtype}")
    c = x.shape[1]
    if c % 8 or c // 8 > _THREADS:
        raise ValueError(f"C={c}: need a multiple of 8 up to {8 * _THREADS}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be contiguous in torch.channels_last")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if x.shape[0] == 0 or (w + 2 * border) * c // 8 >= 2**31:
        raise ValueError(f"unsupported size {tuple(x.shape)}")
    for name, t, n in (("bias", bias, c), ("slope", slope, 1)):
        if t is None:
            continue
        if t.numel() != n or t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be {n} contiguous {x.dtype} value(s) on {x.device}")


def _launch(x, bias, slope, p, q, h, w, border):
    from fast_srgan_torch.kernels._build import load_library

    check_window(x.shape, p, q, h, w, border)
    check_kernel_inputs(x, bias, slope, w, border)
    b, c, hin, win = x.shape
    lib = load_library()
    with torch.cuda.device(x.device):
        out = _fake(x, bias, slope, p, q, h, w, border)
        fn = lib.fsr_tail_epilogue_bf16 if x.dtype == torch.bfloat16 else lib.fsr_tail_epilogue_f32
        err = fn(
            x.data_ptr(), bias.data_ptr(), None if slope is None else slope.data_ptr(),
            out.data_ptr(), b, hin, win, c, h, w, p, q, border,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"tail_epilogue launch failed: cudaError {err}")
    tail_epilogue.launches += 1
    return out


def _fake(x, bias, slope, p, q, h, w, border):
    return torch.empty((x.shape[0], x.shape[1], h + 2 * border, w + 2 * border),
                       dtype=x.dtype, device=x.device, memory_format=torch.channels_last)


_LIB = torch.library.Library("fast_srgan", "FRAGMENT")
_LIB.define("tail_epilogue(Tensor x, Tensor bias, Tensor? slope, int p, int q, int h, int w,"
            " int border) -> Tensor")
_LIB.impl("tail_epilogue", tail_epilogue_reference, "CPU")
_LIB.impl("tail_epilogue", _launch, "CUDA")
torch.library.register_fake("fast_srgan::tail_epilogue", _fake, lib=_LIB)
_OP = torch.ops.fast_srgan.tail_epilogue.default


def tail_epilogue(
    x: torch.Tensor, bias: torch.Tensor, slope: Optional[torch.Tensor] = None,
    offset: Sequence[int] = (0, 0), size: Optional[Sequence[int]] = None, border: int = 0,
) -> torch.Tensor:
    """``prelu(x[:, :, p:p + h, q:q + w] + bias)`` (no PReLU where ``slope``
    is None), zero-padded by ``border``, channels_last: ``offset`` is (p,
    q), ``size`` (h, w), by default the rest of x from the offset.

    ``tail_epilogue.launches`` counts the calls that launched the kernel (a
    CUDA graph's capture counts once, its replays not)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tail_epilogue runs on cpu or cuda, not {x.device}")
    p, q = offset
    h, w = (x.shape[2] - p, x.shape[3] - q) if size is None else size
    return _OP(x, bias, slope, p, q, h, w, border)


tail_epilogue.launches = 0
