"""The JAX package's initialization for the port's modules.

flax's defaults: conv kernels lecun-normal (variance scaling 1.0, fan_in,
a normal truncated at two standard deviations and rescaled so its variance
is 1/fan_in), biases zero; the PReLU slopes start at 0.25 (nn.PReLU's own
default). A port run then starts from the JAX package's distribution.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# std of a standard normal truncated to [-2, 2] (flax's correction constant)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_init_(module: nn.Module, generator: Optional[torch.Generator] = None):
    """Re-initialize every Conv2d under ``module`` in place; return module."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(
                m.weight, std=std, a=-2 * std, b=2 * std, generator=generator
            )
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)
    return module
