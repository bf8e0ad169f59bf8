"""Parameterless instance normalization for NCHW (channels_last) activations.

The counterpart of ``fast_srgan_tpu/ops/norm.py:instance_norm_nhwc``:
torch ``InstanceNorm2d`` semantics (biased variance, eps 1e-5, no affine)
with the JAX package's numerics. Statistics are one-pass fp32 E[x] and
E[x^2]; the variance E[x^2] - E[x]^2 is clamped at 0, because fp32
cancellation on a near-constant channel can drive it slightly negative and
rsqrt would return NaN. The output is cast back to the input dtype.

This is the plain op of the discriminator's norms and of the kernels'
plain versions. The generator's 17 norms go through
``kernels/instance_norm.py``: the 8 that feed a PReLU through
``instance_norm_prelu``, the 9 that a residual add follows through
``instance_norm_add``.

:func:`instance_norm_masked` and :func:`valid_mask` are the counterparts of
``instance_norm_masked_nhwc`` and ``valid_mask_nhwc``: the norm of a
zero-padded frame over each sample's valid region only, which makes the
bucketed ("pad to a shape grid") forward exact. :func:`zero_outside`
re-zeroes the padding after a bias or an activation.
"""

from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-5


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Normalize each (sample, channel) slice of [B, C, H, W] over H, W."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    ex2 = x32.square().mean(dim=(2, 3), keepdim=True)
    var = (ex2 - mean.square()).clamp_min(0.0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def instance_norm_masked(
    x: torch.Tensor, mask: torch.Tensor, count: torch.Tensor, eps: float = EPS
) -> torch.Tensor:
    """Instance norm of [B, C, H, W] x over the valid region of each sample.

    ``mask`` is 1 on valid pixels and 0 on padding, [B, 1, H, W] fp32;
    ``count`` the valid pixels of each sample, [B, 1, 1, 1] fp32. The
    statistics are fp32 sums over ``x * mask`` divided by ``count`` (the
    mask inside the sums matters: a preceding conv smears nonzero values
    into the padding), the variance is clamped at 0, and the output is
    re-masked so the padding stays 0 for the next convolution."""
    x32 = x.float() * mask
    s1 = x32.sum(dim=(2, 3), keepdim=True)
    s2 = x32.square().sum(dim=(2, 3), keepdim=True)
    mean = s1 / count
    var = (s2 / count - mean.square()).clamp_min(0.0)
    return ((x32 - mean) * torch.rsqrt(var + eps) * mask).to(x.dtype)


def valid_mask(
    h: int, w: int, valid_h: torch.Tensor, valid_w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B, 1, H, W] fp32 mask, [B, 1, 1, 1] fp32 count) of a padded frame
    of shape (h, w) from per-sample valid sizes (int [B] tensors), on their
    device."""
    b = valid_h.shape[0]
    dev = valid_h.device
    vh = valid_h.view(b, 1, 1, 1)
    vw = valid_w.view(b, 1, 1, 1)
    iy = torch.arange(h, device=dev).view(1, 1, h, 1)
    ix = torch.arange(w, device=dev).view(1, 1, 1, w)
    mask = ((iy < vh) & (ix < vw)).to(torch.float32)
    return mask, (vh * vw).to(torch.float32)


def zero_outside(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """v where ``mask`` (broadcast over channels) is nonzero, else +0 in v's
    dtype: the padding re-zeroed with no -0.0 (which ``v * mask`` leaves
    where v < 0) reaching the next conv."""
    return torch.where(mask != 0, v, torch.zeros((), dtype=v.dtype, device=v.device))
