"""Bicubic (anti-aliased) resize as two fp32 matrix products.

The port of ``fast_srgan_tpu/ops/resize.py``. The sampling matrices are
built on the host in float64 by the same code (ATen's
``_upsample_bicubic2d_aa``, the PIL-derived separable resampler: A=-0.5 and
dropped, renormalized edge taps with antialias; torch's A=-0.75 with
clamped taps without), cached per (in, out, antialias), and applied as
``LR = M_h @ HR @ M_w^T`` per (sample, channel). The products are plain
fp32 matmuls (full fp32 on the card: matmul TF32 is off by default).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic convolution kernel (A=-0.5 for PIL/AA, A=-0.75 for torch)."""
    x = np.abs(x)
    out = np.zeros_like(x)
    m1 = x < 1.0
    m2 = (x >= 1.0) & (x < 2.0)
    out[m1] = ((a + 2.0) * x[m1] - (a + 3.0)) * x[m1] * x[m1] + 1.0
    out[m2] = (((x[m2] - 5.0) * x[m2] + 8.0) * x[m2] - 4.0) * a
    return out


@functools.lru_cache(maxsize=256)
def bicubic_resize_matrix(
    in_size: int, out_size: int, antialias: bool = True
) -> np.ndarray:
    """Dense [out_size, in_size] float32 resampling matrix along one axis."""
    scale = in_size / out_size
    kscale = max(scale, 1.0) if antialias else 1.0
    a = -0.5 if antialias else -0.75
    support = 2.0 * kscale
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = scale * (i + 0.5)
        if antialias:
            # out-of-range taps are dropped and the rest renormalized
            xmin = max(0, int(center - support + 0.5))
            xmax = min(in_size, int(center + support + 0.5))
            j = np.arange(xmin, xmax, dtype=np.float64)
            w = _cubic((j - center + 0.5) / kscale, a)
            s = w.sum()
            if s != 0.0:
                w = w / s
            mat[i, xmin:xmax] = w
        else:
            # torch plain bicubic: source indices clamped (border replicate)
            lo = int(np.floor(center - support + 0.5))
            hi = int(np.floor(center + support + 0.5))
            j = np.arange(lo, hi, dtype=np.float64)
            w = _cubic(j - center + 0.5, a)
            idx = np.clip(j.astype(np.int64), 0, in_size - 1)
            np.add.at(mat[i], idx, w)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _matrix(in_size: int, out_size: int, antialias: bool, device: torch.device):
    """bicubic_resize_matrix on ``device``, copied there once."""
    return torch.from_numpy(bicubic_resize_matrix(in_size, out_size, antialias)).to(device)


def resize_bicubic(
    x: torch.Tensor, out_h: int, out_w: int, antialias: bool = True
) -> torch.Tensor:
    """Bicubic resize of [B, C, H, W] to [B, C, out_h, out_w] in fp32,
    returned in x's dtype and channels_last."""
    _, _, h, w = x.shape
    y = x.float()
    if h != out_h:
        y = torch.einsum("oh,bchw->bcow", _matrix(h, out_h, antialias, y.device), y)
    if w != out_w:
        y = torch.einsum("ow,bchw->bcho", _matrix(w, out_w, antialias, y.device), y)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)
