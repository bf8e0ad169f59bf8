"""JAX param trees -> the port's state_dicts: the one place names are mapped.

The generator's map is below; the discriminator's and VGG19's are in their
functions at the end of the file.

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

:func:`params_from_state_dict` is the inverse map (OIHW -> HWIO), and
:func:`load_generator_params` reads any generator checkpoint the port
meets: a native ``.npz``, the reference's ``.pt`` (keys prefixed
``_orig_mod.``) or the port trainer's ``generator_epoch_N.pt``.
"""

from __future__ import annotations

import os
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


def _hwio(weight: Any) -> np.ndarray:
    return np.ascontiguousarray(_np32(weight).transpose(2, 3, 1, 0))


def _np32(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().to("cpu", torch.float32).numpy()
    return np.array(leaf, dtype=np.float32)


def _stage_indices(sd: Mapping[str, Any], prefix: str) -> range:
    """range(n) for the keys ``prefix.{i}.*`` of a state_dict."""
    found = [int(k.split(".")[1]) for k in sd if k.startswith(prefix + ".")]
    return range(1 + max(found)) if found else range(0)


def params_from_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_jax_params`: a generator
    state_dict in the reference's names (tensors or arrays, any float dtype;
    torch.compile's ``_orig_mod.`` prefix stripped) -> the numpy fp32 param
    tree with the ``{'params': ...}`` wrapper, kernels HWIO. Raises
    ValueError for a state_dict that is not a generator's."""
    sd = {k.replace("_orig_mod.", ""): v for k, v in state_dict.items()}
    ups = _stage_indices(sd, "upsampling")
    if not ups or "neck.0.weight" not in sd:
        raise ValueError(
            "not a generator state_dict (no 'neck.0.weight' or 'upsampling.*' keys);"
            f" got keys like {sorted(sd)[:5]}"
        )
    p: Dict[str, Any] = {
        "neck_conv": {"kernel": _hwio(sd["neck.0.weight"]), "bias": _np32(sd["neck.0.bias"])},
        "neck_relu": {"alpha": _np32(sd["neck.1.weight"])},
        "bottleneck_conv": {"kernel": _hwio(sd["bottleneck.0.weight"])},
        "head_conv": {"kernel": _hwio(sd["head.0.weight"]), "bias": _np32(sd["head.0.bias"])},
    }
    for i in _stage_indices(sd, "stem"):
        p[f"stem_{i}"] = {
            "conv1": {"kernel": _hwio(sd[f"stem.{i}.conv1.weight"])},
            "relu1": {"alpha": _np32(sd[f"stem.{i}.relu1.weight"])},
            "conv2": {"kernel": _hwio(sd[f"stem.{i}.conv2.weight"])},
        }
    for j in ups:
        p[f"upsampling_{j}"] = {
            "conv": {"kernel": _hwio(sd[f"upsampling.{j}.conv.weight"]),
                     "bias": _np32(sd[f"upsampling.{j}.conv.bias"])},
            "relu": {"alpha": _np32(sd[f"upsampling.{j}.relu.weight"])},
        }
    return {"params": p}


def load_generator_params(path: str) -> Dict[str, Any]:
    """Generator params (numpy, ``{'params': ...}``) from a native ``.npz``
    or a ``.pt`` generator state_dict (the reference's, ``_orig_mod.``
    prefixes stripped, or the port trainer's ``generator_epoch_N.pt``); from
    a SwinIR, HAT or MambaIR ``.pth`` (bare, or under ``params_ema`` or
    ``params``), its state_dict as ``models.swinir.swinir_state_dict``,
    ``models.hat.hat_state_dict`` or ``models.mambair.mambair_state_dict``
    gives it, which the engine takes as it
    takes a generator tree. Raises FileNotFoundError for
    a missing file."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint not found: {path!r} (expected a native .npz or a .pt generator"
            " state_dict)"
        )
    if path.endswith(".npz"):
        from fast_srgan_torch.checkpoints.npz_io import load_npz_params

        return load_npz_params(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    from fast_srgan_torch.models.hat import hat_state_dict
    from fast_srgan_torch.models.mambair import mambair_state_dict
    from fast_srgan_torch.models.swinir import family_of, swinir_state_dict

    family = family_of(obj)
    if family is not None:
        return {"swinir": swinir_state_dict, "hat": hat_state_dict,
                "mambair": mambair_state_dict}[family](obj)
    return params_from_state_dict(obj)


def discriminator_state_dict_from_jax_params(
    params: Mapping[str, Any],
) -> Dict[str, torch.Tensor]:
    """Map a JAX discriminator param tree to the port's (the reference's)
    names: neck_conv -> neck.0, stem_{i}.conv -> stem.{i}.conv, head_conv ->
    stem.7 (the 1x1 conv)."""
    p = params["params"] if "params" in params else params
    sd = {
        "neck.0.weight": _oihw(p["neck_conv"]["kernel"]),
        "neck.0.bias": _vec(p["neck_conv"]["bias"]),
        "stem.7.weight": _oihw(p["head_conv"]["kernel"]),
        "stem.7.bias": _vec(p["head_conv"]["bias"]),
    }
    for i in range(7):
        sd[f"stem.{i}.conv.weight"] = _oihw(p[f"stem_{i}"]["conv"]["kernel"])
    return sd


def vgg_state_dict_from_jax_params(
    params: Mapping[str, Any],
) -> Dict[str, torch.Tensor]:
    """Map a JAX VGG19Features param tree (conv_0 .. conv_14) to torchvision's
    ``features.{idx}`` names."""
    from fast_srgan_torch.models.vgg import conv_indices

    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for n, idx in enumerate(conv_indices()):
        sd[f"features.{idx}.weight"] = _oihw(p[f"conv_{n}"]["kernel"])
        sd[f"features.{idx}.bias"] = _vec(p[f"conv_{n}"]["bias"])
    return sd
