"""The Fast-SRGAN patch discriminator as an ``nn.Module`` (NCHW, channels_last).

The port of ``fast_srgan_tpu/models/discriminator.py``:

  neck: Conv 3->F (k3, p1) + LeakyReLU(0.2)
  stem: 7 SimpleBlocks [Conv(k3, p1, stride s, no bias) -> InstanceNorm
        -> LeakyReLU(0.01)], channels/strides F/2, 2F/1, 2F/2, 4F/1, 4F/2,
        8F/1, 8F/2, then the 1x1 head Conv 8F->1 -> patch logits

The 0.2 / 0.01 slopes are the reference's quirk, kept. Module names are the
reference's (``neck.0``, ``stem.{0..6}.conv``, ``stem.7`` for the head), so
its state_dicts load as they are. F=64 has 4,684,033 parameters; a 96x96
input gives 6x6 logits, returned in fp32. Norms use the plain
``ops.norm.instance_norm`` (the JAX package runs no kernel here).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fast_srgan_torch.ops.norm import instance_norm

_PLAN = ((1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (8, 1), (8, 2))


class SimpleBlock(nn.Module):
    """Conv(k3, stride, no bias) -> InstanceNorm -> LeakyReLU(0.01)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(instance_norm(self.conv(x)), 0.01)


class Discriminator(nn.Module):
    """[B, 3, H, W] in [-1, 1] -> [B, 1, H/16, W/16] fp32 logits."""

    def __init__(self, n_filters: int = 64):
        super().__init__()
        f = n_filters
        self.neck = nn.Sequential(nn.Conv2d(3, f, 3, padding=1), nn.LeakyReLU(0.2))
        blocks = []
        cin = f
        for mult, stride in _PLAN:
            blocks.append(SimpleBlock(cin, mult * f, stride))
            cin = mult * f
        self.stem = nn.Sequential(*blocks, nn.Conv2d(cin, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.neck[0].weight.dtype)
        return self.stem(self.neck(x)).float()
