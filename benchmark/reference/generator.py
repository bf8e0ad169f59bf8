"""The plain reference of the Fast-SRGAN generator: fp32 convolutions, torch's
instance norm, pixel shuffle, PReLU and tanh, as the published PyTorch model
(github.com/HasnainRaz/Fast-SRGAN ``model.py``) writes them. No kernel, no
LR-domain tail, no batching rule; TF32 is off while it runs.

Weights are a dict of fp32 tensors under the published model's names
(``neck.0.weight`` OIHW ...). :func:`weights_from_tree` reads them from the
``.npz`` tree (``params/<layer>/kernel`` HWIO) that the serving cells load.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
#: a hook around a conv: (name, input, weight, conv) -> output, where
#: conv(input, weight) is the conv with its bias, stride and padding
ConvHook = Optional[Callable[..., torch.Tensor]]


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for matmuls and cuDNN convolutions while the block runs."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def weights_from_tree(tree: Dict, device) -> Weights:
    """The generator's weights from a ``{'params': {...}}`` tree of numpy
    leaves (HWIO kernels), as fp32 tensors on ``device``."""
    p = tree["params"] if "params" in tree else tree

    def k(leaf):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf, np.float32)
                                                     .transpose(3, 2, 0, 1))).to(device)

    def v(leaf):
        return torch.from_numpy(np.asarray(leaf, np.float32).copy()).to(device)

    w = {"neck.0.weight": k(p["neck_conv"]["kernel"]), "neck.0.bias": v(p["neck_conv"]["bias"]),
         "neck.1.weight": v(p["neck_relu"]["alpha"]),
         "bottleneck.0.weight": k(p["bottleneck_conv"]["kernel"]),
         "head.0.weight": k(p["head_conv"]["kernel"]), "head.0.bias": v(p["head_conv"]["bias"])}
    i = 0
    while f"stem_{i}" in p:
        b = p[f"stem_{i}"]
        w[f"stem.{i}.conv1.weight"] = k(b["conv1"]["kernel"])
        w[f"stem.{i}.relu1.weight"] = v(b["relu1"]["alpha"])
        w[f"stem.{i}.conv2.weight"] = k(b["conv2"]["kernel"])
        i += 1
    j = 0
    while f"upsampling_{j}" in p:
        b = p[f"upsampling_{j}"]
        w[f"upsampling.{j}.conv.weight"] = k(b["conv"]["kernel"])
        w[f"upsampling.{j}.conv.bias"] = v(b["conv"]["bias"])
        w[f"upsampling.{j}.relu.weight"] = v(b["relu"]["alpha"])
        j += 1
    return w


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, a * x)


def conv(w: Weights, name: str, x: torch.Tensor, hook: ConvHook, stride: int = 1) -> torch.Tensor:
    """Layer ``name``'s conv (its weight, bias if any, same padding), through
    ``hook`` where one is given."""
    weight, bias = w[f"{name}.weight"], w.get(f"{name}.bias")

    def run(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return F.conv2d(a, b, bias, stride=stride, padding=b.shape[-1] // 2)

    return run(x, weight) if hook is None else hook(name, x, weight, run)


def generator(w: Weights, x: torch.Tensor, hook: ConvHook = None) -> torch.Tensor:
    """[B, 3, H, W] in [-1, 1] -> [B, 3, sH, sW] in [-1, 1], fp32."""
    n_layers = sum(1 for k in w if k.endswith(".conv1.weight"))
    n_stages = sum(1 for k in w if k.startswith("upsampling.") and k.endswith("conv.weight"))
    residual = prelu(conv(w, "neck.0", x, hook), w["neck.1.weight"])
    y = residual
    for i in range(n_layers):
        t = prelu(F.instance_norm(conv(w, f"stem.{i}.conv1", y, hook)), w[f"stem.{i}.relu1.weight"])
        y = F.instance_norm(conv(w, f"stem.{i}.conv2", t, hook)) + y
    y = F.instance_norm(conv(w, "bottleneck.0", y, hook)) + residual
    for j in range(n_stages):
        y = F.pixel_shuffle(conv(w, f"upsampling.{j}.conv", y, hook), 2)
        y = prelu(y, w[f"upsampling.{j}.relu.weight"])
    return torch.tanh(conv(w, "head.0", y, hook))


def upscale_u8(w: Weights, frames_u8: torch.Tensor, hook: ConvHook = None) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, sH, sW, 3] uint8: x / 127.5 - 1 in, (y + 1)
    * 127.5 clamped to [0, 255] and truncated out (the reference's serving
    normalization), fp32 with TF32 off."""
    with torch.no_grad(), fp32_exact():
        x = frames_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        y = generator(w, x, hook)
        return ((y + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
