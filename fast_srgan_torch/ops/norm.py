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
"""

from __future__ import annotations

import torch

EPS = 1e-5


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Normalize each (sample, channel) slice of [B, C, H, W] over H, W."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    ex2 = x32.square().mean(dim=(2, 3), keepdim=True)
    var = (ex2 - mean.square()).clamp_min(0.0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
