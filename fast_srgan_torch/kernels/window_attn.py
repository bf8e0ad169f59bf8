"""One Swin layer's shifted-window attention: the CUDA kernel and its plain version.

SwinIR's attention (``models/swinir.py``) on the qkv linear's output in
token layout, ``qkv`` [B, H, W, 3C] (a token's q, k and v, each ``heads``
heads of hd = C / heads in order), with s the layer's shift (0 or window / 2):

    t = roll(qkv, (-s, -s))                              the shifted map
    o = softmax(q k^T * scale + masks[class]) v          each window of t, head
    out = roll(reverse(o), (s, s))                       [B, H, W, C]

``masks`` [K, heads, N, N] (N = window^2) holds the layer's masks by window
class: K = 1 unshifted (the relative-position bias, class 0), K = 4 shifted
(the bias plus the shift mask of the interior, the last window column, the
last window row and the corner: :func:`window_regions`' classes 0 to 3).

:func:`window_attn_reference` is that, written out: ``torch.roll``, the
windows partitioned region by region (:func:`partition`), fp32 matmuls and
softmax, then :func:`reverse` and the roll back. The kernel
(``csrc/window_attn.cu``) reads each window's tokens at their place in
``qkv``, the rolls and the partition folded into its addresses, and writes
the output back at the same place in one launch. In bf16 its logits and
softmax are fp32 and P is rounded to bf16 for P V; in fp32 every product
and sum is fp32. It takes window 8 in bf16 and fp32 (every published SwinIR
SR model: head 30 at C = 180 or 240, lightweight head 10 at C = 60) and
window 16 in bf16 (HAT, ``models/hat.py``: head 30 at C = 180), each with an
even head size of at most 32 and C a multiple of 4. At window 16 the kernel
takes one (window, head) a block and the keys in chunks with an online
softmax, since a window's qkv is more than a block's shared memory.

The ``torch.library`` op ``fast_srgan::window_attn`` dispatches on the
tensor: its CPU implementation is the plain version; its CUDA one launches
the kernel or raises ``ValueError`` for what the kernel does not take.
There is no fallback between the two.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

#: the windows the kernel takes (csrc/window_attn.cu kWindow, kWindow16),
#: and the types it takes at each (its entry points)
KERNEL_WINDOWS = {8: (torch.bfloat16, torch.float32), 16: (torch.bfloat16,)}
#: the largest head size the kernel takes (zero-padded to 32 in registers)
KERNEL_MAX_HEAD = 32
#: one block's shared memory on Hopper; at window 8 the kernel holds a
#: window's qkv, 192 C + 32 values (at 16, one head's, which always fits)
SMEM_BYTES = 232_448


def window_regions(h: int, w: int, window: int, shifted: bool
                   ) -> List[Tuple[slice, slice, int, int, int]]:
    """(rows, columns, windows down, windows across, mask class) of each
    part of an (h, w) map whose windows share one mask, in the order
    :func:`partition` lays them out: unshifted, the whole map (class 0);
    shifted, the interior, the last column, the last row and the corner
    (classes 0 to 3, the windows of ``shift_mask(2w, 2w, ...)``), each
    where it holds a window."""
    if not shifted:
        return [(slice(0, h), slice(0, w), h // window, w // window, 0)]
    rows = ((slice(0, h - window), h // window - 1), (slice(h - window, h), 1))
    cols = ((slice(0, w - window), w // window - 1), (slice(w - window, w), 1))
    return [(rs, cs, nh, nw, 2 * i + j) for i, (rs, nh) in enumerate(rows)
            for j, (cs, nw) in enumerate(cols) if nh and nw]


def partition(t: torch.Tensor, window: int, regions) -> torch.Tensor:
    """[B, H, W, C] -> [M, N, C] windows: each region's in turn, batch-major
    and row-major within it; one copy a region."""
    b, c = t.shape[0], t.shape[-1]
    out = t.new_empty(b * sum(r[2] * r[3] for r in regions), window * window, c)
    at = 0
    for rs, cs, nh, nw, _ in regions:
        n = b * nh * nw
        out[at:at + n].view(b, nh, nw, window, window, c).copy_(
            t[:, rs, cs].view(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5))
        at += n
    return out


def reverse(o: torch.Tensor, window: int, regions, h: int, w: int) -> torch.Tensor:
    """:func:`partition`'s inverse: [M, N, C] windows -> [B, H, W, C]."""
    c = o.shape[-1]
    b = o.shape[0] // sum(r[2] * r[3] for r in regions)
    out = o.new_empty(b, h, w, c)
    at = 0
    for rs, cs, nh, nw, _ in regions:
        n = b * nh * nw
        out[:, rs, cs].view(b, nh, window, nw, window, c).copy_(
            o[at:at + n].view(b, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5))
        at += n
    return out


def check_shapes(qkv_shape: Sequence[int], masks_shape: Sequence[int], shift: int
                 ) -> Tuple[int, int, int]:
    """(window, heads, head size) of a call, or ValueError where the shapes
    are not one layer's qkv and masks."""
    if len(qkv_shape) != 4 or qkv_shape[-1] % 3:
        raise ValueError(f"qkv must be [B, H, W, 3C], got shape {tuple(qkv_shape)}")
    b, h, w, c3 = qkv_shape
    if len(masks_shape) != 4 or masks_shape[2] != masks_shape[3]:
        raise ValueError(f"masks must be [K, heads, N, N], got shape {tuple(masks_shape)}")
    k, heads, n, _ = masks_shape
    window = math.isqrt(n)
    c = c3 // 3
    if window * window != n or heads < 1 or c % heads:
        raise ValueError(f"masks {tuple(masks_shape)} do not fit C={c}: N must be a square,"
                         " heads must divide C")
    if min(b, h, w) < 1 or h % window or w % window:
        raise ValueError(f"qkv {tuple(qkv_shape)}: H and W must be multiples of the window"
                         f" {window}")
    if shift not in (0, window // 2) or k != (4 if shift else 1):
        raise ValueError(f"shift {shift} with {k} mask classes: shift 0 takes 1,"
                         f" shift {window // 2} takes 4")
    return window, heads, c // heads


def check_kernel_shapes(qkv_shape: Sequence[int], masks_shape: Sequence[int], shift: int,
                        dtype: torch.dtype) -> None:
    """Raise ValueError unless the kernel takes a call of these shapes in
    ``dtype``."""
    window, heads, hd = check_shapes(qkv_shape, masks_shape, shift)
    if window not in KERNEL_WINDOWS:
        raise ValueError(f"window_attn's kernel takes window 8 or 16, not {window}")
    if hd > KERNEL_MAX_HEAD or hd % 2:
        raise ValueError(f"window_attn's kernel takes an even head size of at most"
                         f" {KERNEL_MAX_HEAD}, not {hd}")
    c = qkv_shape[-1] // 3
    if c % 4:
        raise ValueError(f"window_attn's kernel takes C a multiple of 4, not {c}")
    if dtype not in KERNEL_WINDOWS[window]:
        names = " or ".join({torch.bfloat16: "bf16", torch.float32: "fp32"}[t]
                            for t in KERNEL_WINDOWS[window])
        raise ValueError(f"window_attn's kernel takes {names} at window {window}, not {dtype}")
    smem = (192 * c + 32) * torch.finfo(dtype).bits // 8
    if window == 8 and smem > SMEM_BYTES:
        raise ValueError(f"C={c}: a window's qkv in {dtype} ({smem} bytes) exceeds one block's"
                         f" {SMEM_BYTES} bytes of shared memory")


def _check_kernel_tensors(qkv: torch.Tensor, masks: torch.Tensor, shift: int) -> None:
    check_kernel_shapes(qkv.shape, masks.shape, shift, qkv.dtype)
    if masks.dtype != qkv.dtype:
        raise ValueError(f"window_attn's masks must be qkv's {qkv.dtype}, not {masks.dtype}")
    for name, t in (("qkv", qkv), ("masks", masks)):
        if t.device != qkv.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned on {qkv.device}")


def window_attn_reference(qkv: torch.Tensor, masks: torch.Tensor, shift: int,
                          scale: float) -> torch.Tensor:
    """Plain version: [B, H, W, C] in qkv's type, computed in fp32."""
    window, heads, hd = check_shapes(qkv.shape, masks.shape, shift)
    b, h, w, c3 = qkv.shape
    n, c = window * window, c3 // 3
    regions = window_regions(h, w, window, bool(shift))
    t = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = partition(t, window, regions).float()
    q, k, v = x.view(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)  # [M, heads, N, hd]
    o = torch.empty(x.shape[0], n, c, device=qkv.device)
    at = 0
    for _, _, nh, nw, cls in regions:
        run = slice(at, at + b * nh * nw)
        logits = (q[run] * scale) @ k[run].transpose(-2, -1) + masks[cls].float()
        o[run] = (logits.softmax(-1) @ v[run]).transpose(1, 2).reshape(-1, n, c)
        at = run.stop
    o = reverse(o.to(qkv.dtype), window, regions, h, w)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def _launch(qkv, masks, shift, scale):
    from fast_srgan_torch.kernels._build import load_library

    _check_kernel_tensors(qkv, masks, shift)
    b, h, w, c3 = qkv.shape
    lib = load_library()
    with torch.cuda.device(qkv.device):
        out = _fake(qkv, masks, shift, scale)
        if masks.shape[-1] != 64:
            fn = lib.fsr_window_attn16_bf16
        elif qkv.dtype == torch.bfloat16:
            fn = lib.fsr_window_attn_bf16
        else:
            fn = lib.fsr_window_attn_f32
        err = fn(
            qkv.data_ptr(), masks.data_ptr(), out.data_ptr(), b, h, w, c3 // 3,
            masks.shape[1], shift, scale, torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"window_attn launch failed: cudaError {err}")
    window_attn.launches += 1
    return out


def _fake(qkv, masks, shift, scale):
    b, h, w, c3 = qkv.shape
    return qkv.new_empty((b, h, w, c3 // 3))


_LIB = torch.library.Library("fast_srgan", "FRAGMENT")
_LIB.define("window_attn(Tensor qkv, Tensor masks, int shift, float scale) -> Tensor")
_LIB.impl("window_attn", window_attn_reference, "CPU")
_LIB.impl("window_attn", _launch, "CUDA")
torch.library.register_fake("fast_srgan::window_attn", _fake, lib=_LIB)
_OP = torch.ops.fast_srgan.window_attn.default


def window_attn(qkv: torch.Tensor, masks: torch.Tensor, shift: int, scale: float) -> torch.Tensor:
    """One layer's window attention, [B, H, W, 3C] -> [B, H, W, C] (the
    module docstring); ``scale`` is the true head size's hd^-0.5.

    ``window_attn.launches`` counts the calls that launched the kernel (a
    CUDA graph's capture counts once, its replays not)."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attn runs on cpu or cuda, not {qkv.device}")
    return _OP(qkv, masks, shift, scale)


window_attn.launches = 0
