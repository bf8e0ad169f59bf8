"""Loss functions with the reference's torch semantics, taken in fp32.

The port of ``fast_srgan_tpu/train/losses.py``: SmoothL1 (beta 1, mean) and
BCE-with-logits (mean, the stable log-sum-exp form), both on fp32 copies of
their inputs whatever the compute dtype.
"""

from __future__ import annotations

import torch


def smooth_l1_loss(
    pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0
) -> torch.Tensor:
    """Huber-style smooth L1, mean reduction (torch SmoothL1Loss defaults)."""
    diff = pred.float() - target.float()
    abs_diff = diff.abs()
    loss = torch.where(
        abs_diff < beta, 0.5 * diff * diff / beta, abs_diff - 0.5 * beta
    )
    return loss.mean()


def bce_with_logits_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sigmoid cross-entropy from logits, mean reduction, stable form:
    max(x,0) - x*z + log1p(exp(-|x|))."""
    x = logits.float()
    z = targets.float()
    return (x.clamp_min(0.0) - x * z + torch.log1p(torch.exp(-x.abs()))).mean()
