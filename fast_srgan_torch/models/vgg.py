"""Frozen VGG19 perceptual features (torchvision ``vgg19().features[:34]``).

The port of ``fast_srgan_tpu/models/vgg.py``: the conv stack of
configuration 'E' up to the ReLU after conv5_3 (512 channels at 1/16
resolution). The input maps from [-1, 1] to [0, 1] and is ImageNet-
normalized in fp32 before the convs. Modules sit at torchvision's indices
(``features.{idx}``: convs at 0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25,
28, 30, 32), so a torchvision ``vgg19`` state_dict loads through
:func:`load_torchvision_state_dict` with its classifier keys ignored. The
module is frozen: no parameter takes a gradient, and it is in eval mode.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

PLAN = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
    512, 512, 512, 512, "M", 512, 512, 512,
)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def conv_indices() -> list:
    """torchvision ``features`` indices of the 15 convs."""
    out, idx = [], 0
    for item in PLAN:
        if item != "M":
            out.append(idx)
        idx += 1 if item == "M" else 2
    return out


class VGG19Features(nn.Module):
    """[B, 3, H, W] in [-1, 1] -> [B, 512, H/16, W/16] fp32 features."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for item in PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, item, 3, padding=1), nn.ReLU()]
                cin = item
        self.features = nn.Sequential(*layers)
        self.register_buffer(
            "mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1), persistent=False
        )
        self.register_buffer(
            "std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1), persistent=False
        )
        self.requires_grad_(False)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ((x.float() + 1.0) / 2.0 - self.mean) / self.std
        x = x.to(self.features[0].weight.dtype)
        return self.features(x.contiguous(memory_format=torch.channels_last)).float()


def load_torchvision_state_dict(
    model: VGG19Features, sd: Mapping[str, torch.Tensor]
) -> VGG19Features:
    """Load a torchvision ``vgg19`` state_dict (or its features alone);
    keys outside ``features[:34]`` are ignored, a missing one raises."""
    keep = {f"features.{i}.{part}" for i in conv_indices() for part in ("weight", "bias")}
    missing = sorted(keep - set(sd))
    if missing:
        raise ValueError(
            f"not a torchvision vgg19 state_dict: missing {len(missing)} keys "
            f"(first: {missing[:4]})"
        )
    model.load_state_dict({k: sd[k] for k in keep})
    return model
