"""The Fast-SRGAN generator as an ``nn.Module`` (NCHW, channels_last).

The port of ``fast_srgan_tpu/models/generator.py``:

  neck:       Conv 3->F (k3, p1) + PReLU
  stem:       n_layers x ResidualBlock
                Conv(k3, no bias) -> InstanceNorm+PReLU (fused kernel)
                -> Conv(no bias) -> InstanceNorm + x (fused kernel)
  bottleneck: Conv(no bias) -> InstanceNorm + long skip (fused kernel)
  upsampling: log2(scale) x [Conv F->4F (k3) -> PixelShuffle(2) -> PReLU]
                (fused_upsample=True: one kernel, kernels/fused_upsample.py,
                for the shapes it takes; else the conv's output channels come
                out phase-major and the shuffle is the copy kernel of
                kernels/pixel_shuffle.py)
  head:       Conv F->3 (k3) + tanh (in fp32) -> output in [-1, 1]

Module names are the original Fast-SRGAN PyTorch ones (``neck.0``,
``stem.{i}.conv1``, ``upsampling.{j}.relu`` ...), so its state_dicts load
as they are. The default (n_filters=64, n_layers=8, scale 4) has 925,646
parameters. The compute dtype is the parameters' dtype: cast the module
(``.to(torch.bfloat16)``) to run in bf16, or keep fp32 parameters under
``torch.autocast`` (training); every PReLU slope is cast to the activation
dtype, and norm statistics stay fp32. Each kernel's wrapper picks its path
from the tensor's device (the kernel on CUDA, the plain version on the
CPU); there is no switch for it, as the JAX package's ``use_pallas`` is.

``valid_hw`` (int32 [B] valid heights and widths, on the input's device)
runs the exact masked forward of a zero-padded (bucketed) batch: every norm
takes its statistics over each sample's valid region (the kernels' masked
form), and the padding is re-zeroed after each bias, so each valid output
pixel is what the unpadded forward gives. The output's padded margin is
garbage; the caller crops it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fast_srgan_torch.kernels.fused_upsample import fused_upsample, kernel_takes
from fast_srgan_torch.kernels.instance_norm import (
    instance_norm_add,
    instance_norm_prelu,
)
from fast_srgan_torch.kernels.pixel_shuffle import (
    phase_major_permutation,
    pixel_shuffle_phase_major,
)
from fast_srgan_torch.ops.norm import valid_mask, zero_outside

_STAGES = {2: 1, 4: 2, 8: 3}


def _conv3x3(cin: int, cout: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


def prelu(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Single-slope PReLU with the slope cast to x's dtype (JAX ``PReLU``)."""
    return torch.where(x >= 0, x, weight.to(x.dtype) * x)


class ResidualBlock(nn.Module):
    """conv -> IN+PReLU -> conv -> IN, identity skip after the 2nd norm."""

    def __init__(self, n_filters: int):
        super().__init__()
        self.conv1 = _conv3x3(n_filters, n_filters, bias=False)
        self.relu1 = nn.PReLU(1)  # its slope feeds the fused kernel
        self.conv2 = _conv3x3(n_filters, n_filters, bias=False)

    def forward(self, x: torch.Tensor, valid_hw=None) -> torch.Tensor:
        y = instance_norm_prelu(self.conv1(x), self.relu1.weight, valid_hw)
        return instance_norm_add(self.conv2(y), x, valid_hw)


class UpSamplingBlock(nn.Module):
    """Conv F->4F (k3) -> PixelShuffle(2) -> PReLU: one 2x stage.

    Fused: the whole stage is one kernel, where the kernel takes the
    shapes (``kernel_takes``: 64 input channels, bf16 or fp32, a size its
    launch takes); any other stage runs unfused, the same function, in the
    forward and the backward alike. Unfused: the conv runs with its
    output channels permuted to phase-major order (a gather of weight and
    bias, not of the activation), so the shuffle is a plain copy. The parameters are
    the same either way, in torch channel order. The permutation is a
    buffer (not saved in the state_dict), so ``torch.export`` holds it as
    module state and it follows the module to its device."""

    def __init__(self, n_filters: int, fused: bool = False):
        super().__init__()
        self.conv = _conv3x3(n_filters, 4 * n_filters)
        self.relu = nn.PReLU(1)
        self.fused = fused
        self.register_buffer(
            "perm", torch.from_numpy(phase_major_permutation(4 * n_filters)), persistent=False
        )

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """``mask`` ([B, 1, H, W], x's resolution) re-zeroes the padding that
        the conv's bias fills in, before the shuffle (which carries the
        zeros to the 2x grid; channel order does not matter to it)."""
        return upsample_stage(x, self.conv.weight, self.conv.bias, self.relu.weight,
                              self.fused, self.perm, mask)


def upsample_stage(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   alpha: Optional[torch.Tensor], fused: bool,
                   perm: Optional[torch.Tensor] = None, mask=None) -> torch.Tensor:
    """One 2x stage, conv -> PixelShuffle(2) -> PReLU(``alpha``), or no
    activation where ``alpha`` is None (SwinIR's upsampler): the fused
    kernel where ``fused`` and it takes the shapes (with ``prelu=False``
    without a slope), else the conv with its output channels in
    phase-major order (``perm``) and the copy shuffle, or, given no
    ``perm``, the conv and ``F.pixel_shuffle``."""
    if fused:
        if mask is not None:
            raise ValueError("fused upsample does not support masking")
        if kernel_takes(x, weight):
            if alpha is None:
                return fused_upsample(x, weight, bias, bias[:1], prelu=False)
            return fused_upsample(x, weight, bias, alpha)
    if perm is None:
        y = F.conv2d(x, weight, bias, padding=1)
        if mask is not None:
            y = zero_outside(y, mask)
        y = F.pixel_shuffle(y, 2)
    else:
        y = F.conv2d(x, weight[perm], bias[perm], padding=1)
        if mask is not None:
            y = zero_outside(y, mask)
        y = pixel_shuffle_phase_major(y.contiguous(memory_format=torch.channels_last))
    return y if alpha is None else prelu(y, alpha)


class Generator(nn.Module):
    """Fully-convolutional SR generator; [B, 3, H, W] in [-1, 1] ->
    [B, 3, sH, sW] fp32 in [-1, 1], s = scale_factor (2, 4 or 8)."""

    def __init__(
        self,
        n_filters: int = 64,
        n_layers: int = 8,
        scale_factor: int = 4,
        fused_upsample: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        if scale_factor not in _STAGES:
            raise ValueError(
                f"scale_factor must be 2, 4, or 8; got {scale_factor}"
            )
        self.n_filters = n_filters
        self.n_layers = n_layers
        self.scale_factor = scale_factor
        # training.remat: each ResidualBlock under torch.utils.checkpoint
        # when autograd records (the JAX package's nn.remat(ResidualBlock));
        # the backward recomputes the block, its IN kernels' forwards too
        self.remat = remat
        self.neck = nn.Sequential(_conv3x3(3, n_filters), nn.PReLU(1))
        self.stem = nn.ModuleList(
            ResidualBlock(n_filters) for _ in range(n_layers)
        )
        self.bottleneck = nn.Sequential(
            _conv3x3(n_filters, n_filters, bias=False)
        )
        self.upsampling = nn.ModuleList(
            UpSamplingBlock(n_filters, fused_upsample)
            for _ in range(_STAGES[scale_factor])
        )
        self.head = nn.Sequential(_conv3x3(n_filters, 3))

    def trunk(self, x: torch.Tensor, valid_hw=None) -> torch.Tensor:
        """neck -> stem -> bottleneck (+ long skip): the LR feature map;
        masked with ``valid_hw``."""
        x = x.to(self.neck[0].weight.dtype)
        residual = self.neck[0](x)
        if valid_hw is not None:  # re-zero what the bias filled in
            residual = zero_outside(residual, valid_mask(x.shape[2], x.shape[3], *valid_hw)[0])
        residual = prelu(residual, self.neck[1].weight)
        y = residual
        for block in self.stem:
            if self.remat and torch.is_grad_enabled():
                y = checkpoint(block, y, valid_hw, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                y = block(y, valid_hw)
        return instance_norm_add(self.bottleneck(y), residual, valid_hw)

    def tail(self, y: torch.Tensor, valid_hw=None) -> torch.Tensor:
        """The canonical upsampling tail and head on a trunk output; masked
        with ``valid_hw`` (the LR valid sizes), the mask rebuilt at 2x
        between stages."""
        for i, stage in enumerate(self.upsampling):
            mask = None
            if valid_hw is not None:
                k = 2**i
                mask = valid_mask(y.shape[2], y.shape[3], valid_hw[0] * k, valid_hw[1] * k)[0]
            y = stage(y, mask)
        return torch.tanh(self.head(y).float())

    def forward(
        self, x: torch.Tensor, trunk_only: bool = False, valid_hw=None
    ) -> torch.Tensor:
        y = self.trunk(x, valid_hw)
        return y if trunk_only else self.tail(y, valid_hw)
