"""The one general generator of the benchmark's inputs: every traffic mix is
a data file of parameters (``traffic/<name>.json``) that these functions
read. Everything is drawn from the run's seed, on the device the run uses,
in a few large calls; the same seed gives the same inputs on one kind of
device.

One kind of mix so far, ``frames``: a set of distinct structured uint8
frames of one size, cycled in order (video).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def structured_images(n: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """[n, h, w, 3] uint8 images that look like content rather than noise:
    per channel, four random plane waves, one hard-edged square wave, and
    mild noise, drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = lambda *shape: torch.rand(shape, generator=gen, device=device)  # noqa: E731
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, 1, h, 1) / h
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, 1, w) / w
    img = torch.full((n, 3, h, w), 0.5, device=device)
    for _ in range(4):
        fy, fx = (0.5 + 5.5 * u(n, 3, 1, 1)), (0.5 + 5.5 * u(n, 3, 1, 1))
        phase, amp = 2 * math.pi * u(n, 3, 1, 1), 0.05 + 0.15 * u(n, 3, 1, 1)
        img += amp * torch.sin(2 * math.pi * (fy * yy + fx * xx) + phase)
    fy, fx = 1 + 3 * u(n, 1, 1, 1), 1 + 3 * u(n, 1, 1, 1)
    img += 0.15 * torch.sign(torch.sin(2 * math.pi * fy * yy) * torch.sin(2 * math.pi * fx * xx))
    img += 0.04 * torch.randn((n, 3, h, w), generator=gen, device=device)
    return (img.clamp(0, 1) * 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def frames(mix: Dict, seed: int, device) -> np.ndarray:
    """The ``frames`` mix: [distinct_frames, frame_h, frame_w, 3] uint8 on
    the host."""
    return structured_images(mix["distinct_frames"], mix["frame_h"], mix["frame_w"],
                             seed, device).cpu().numpy()
