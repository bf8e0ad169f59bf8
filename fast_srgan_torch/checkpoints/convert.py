"""JAX param tree -> the port's state_dict: the one place names are mapped.

The port's modules carry the original Fast-SRGAN PyTorch names, so an
original ``.pt`` generator state_dict (with torch.compile's ``_orig_mod.``
prefix stripped) loads through ``load_state_dict`` as it is:

    neck_conv.{kernel,bias}            -> neck.0.{weight,bias}
    neck_relu.alpha                    -> neck.1.weight
    stem_{i}.conv1.kernel              -> stem.{i}.conv1.weight
    stem_{i}.relu1.alpha               -> stem.{i}.relu1.weight
    stem_{i}.conv2.kernel              -> stem.{i}.conv2.weight
    bottleneck_conv.kernel             -> bottleneck.0.weight
    upsampling_{j}.conv.{kernel,bias}  -> upsampling.{j}.conv.{weight,bias}
    upsampling_{j}.relu.alpha          -> upsampling.{j}.relu.weight
    head_conv.{kernel,bias}            -> head.0.{weight,bias}

Conv kernels go HWIO -> OIHW. No pixel-shuffle channel permutation is
needed: the JAX package's ``pixel_shuffle_nhwc`` already uses torch's
channel order (c*r*r + i*r + j).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _oihw(kernel_hwio: Any) -> torch.Tensor:
    k = np.asarray(kernel_hwio, dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _vec(leaf: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def state_dict_from_jax_params(
    params: Mapping[str, Any],
) -> Dict[str, torch.Tensor]:
    """Map a generator param tree (numpy leaves, with or without the
    ``'params'`` wrapper) to the port's fp32 CPU state_dict."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {
        "neck.0.weight": _oihw(p["neck_conv"]["kernel"]),
        "neck.0.bias": _vec(p["neck_conv"]["bias"]),
        "neck.1.weight": _vec(p["neck_relu"]["alpha"]),
        "bottleneck.0.weight": _oihw(p["bottleneck_conv"]["kernel"]),
        "head.0.weight": _oihw(p["head_conv"]["kernel"]),
        "head.0.bias": _vec(p["head_conv"]["bias"]),
    }
    n_layers = sum(1 for k in p if str(k).startswith("stem_"))
    for i in range(n_layers):
        blk = p[f"stem_{i}"]
        sd[f"stem.{i}.conv1.weight"] = _oihw(blk["conv1"]["kernel"])
        sd[f"stem.{i}.relu1.weight"] = _vec(blk["relu1"]["alpha"])
        sd[f"stem.{i}.conv2.weight"] = _oihw(blk["conv2"]["kernel"])
    n_up = sum(1 for k in p if str(k).startswith("upsampling_"))
    for j in range(n_up):
        blk = p[f"upsampling_{j}"]
        sd[f"upsampling.{j}.conv.weight"] = _oihw(blk["conv"]["kernel"])
        sd[f"upsampling.{j}.conv.bias"] = _vec(blk["conv"]["bias"])
        sd[f"upsampling.{j}.relu.weight"] = _vec(blk["relu"]["alpha"])
    return sd
