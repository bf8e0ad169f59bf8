"""fp32 convolutions that are fp32 on the card."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def cudnn_without_tf32():
    """cuDNN runs fp32 convolutions in TF32 by default; inside this context
    fp32 means fp32. The other cuDNN flags keep their current values."""
    with torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled,
        benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic,
        allow_tf32=False,
    ):
        yield


def fp32_precision(fp32: bool, device: torch.device):
    """:func:`cudnn_without_tf32` where fp32 convolutions run on the card,
    else a context that changes nothing."""
    if fp32 and torch.device(device).type == "cuda":
        return cudnn_without_tf32()
    return contextlib.nullcontext()
