"""Dihedral data augmentation of the uint8 HR crops: the port of
``fast_srgan_tpu/ops/augment.py``.

The reference trains with random crops only; ``training.augment=true`` opts
into the full dihedral group D4 (8 symmetries), generated per sample by
three independent coin flips: horizontal flip, vertical flip, transpose.
The training steps apply it on the device before LR synthesis, so the LR
image is the bicubic downsample of the augmented HR crop.

The JAX function draws its coins from a key inside the step; here the draw
(:func:`draw_coins`, from an explicit ``torch.Generator``) and the
transform (:func:`apply_dihedral`) are split, so the transform can be held
against JAX's ``jnp.where`` composition on the same coins. The transpose
coin is skipped where H != W (flips only), keeping the output's shape.
"""

from __future__ import annotations

import torch


def draw_coins(n: int, generator: torch.Generator) -> torch.Tensor:
    """Three fair coins per sample: bool [3, n] (hflip, vflip, transpose),
    on the generator's device."""
    return torch.rand((3, n), generator=generator, device=generator.device) < 0.5


def apply_dihedral(x: torch.Tensor, coins: torch.Tensor) -> torch.Tensor:
    """Per-sample D4 transform of an NHWC batch by ``coins`` (bool [3, N] on
    x's device): flip W where coins[0], then H where coins[1], then swap H
    and W where coins[2] (square inputs only)."""
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    if tuple(coins.shape) != (3, n):
        raise ValueError(f"coins must be [3, {n}], got {tuple(coins.shape)}")
    c = coins.view(3, n, 1, 1, 1)
    x = torch.where(c[0], x.flip(2), x)
    x = torch.where(c[1], x.flip(1), x)
    if h == w:
        x = torch.where(c[2], x.transpose(1, 2), x)
    return x
