"""Hydra-style YAML config with dotted overrides: the port of
``fast_srgan_tpu/config.py``.

A copy, not an import: the port imports nothing of ``fast_srgan_tpu``. Same
schema, same defaults (but ``training.device``, see DEFAULTS), the same
``a.b.c=value`` override rules. PyYAML is imported only by the functions
that parse YAML text, so ``default_config`` works where it is not installed.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Iterable, Mapping

# pyyaml follows YAML 1.1, where `1e-4` (no dot) resolves to a *string*;
# OmegaConf/Hydra accept it as a float. Coerce such numeric-looking strings
# so the reference YAML keeps its meaning.
# Only the forms YAML 1.1 mis-parses as STRINGS despite being numeric in
# OmegaConf: scientific notation without a dot (`1e-4`) or with an
# unsigned exponent (`1.5e4`) — PyYAML's 1.1 float resolver requires
# both a dot and a signed exponent. Plain numbers (`2024`, `3.5`) are
# already numeric when unquoted, so a plain numeric STRING reaching the
# coercer must have been explicitly quoted and stays a string, matching
# OmegaConf (e.g. experiment.name: "2024").
_NUMERIC_RE = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)[eE][-+]?\d+$")


class ConfigNode(dict):
    """A dict with attribute access, recursively wrapping nested mappings."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, ConfigNode):
            value = ConfigNode(value)
        super().__setitem__(key, value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigNode({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, ConfigNode) else v for k, v in self.items()
        }


# Defaults mirror the reference schema (configs/config.yaml) and the JAX
# package's DEFAULTS, key for key. One value differs: training.device is
# "cuda" here (the JAX package says "tpu"); nothing in the port reads it.
DEFAULTS: dict = {
    "experiment": {"name": "SRGAN", "seed": 1234},
    "data": {
        "image_dir": "data/DIV2K",
        "numpy_dir": "data/div2k_np",
        "lr_image_size": 24,
        "scale_factor": 4,
        # --- additions to the reference schema ---
        # Held-out validation images. The reference validates on random
        # crops of the TRAINING images (reference train.py:81-91 — no
        # held-out split exists there). Set val_image_dir to a directory
        # of validation images (e.g. DIV2K_valid_HR) to compute PSNR/SSIM
        # and render fixed panels on unseen data instead. val_numpy_dir
        # defaults to "<numpy_dir>_val".
        "val_image_dir": None,
        "val_numpy_dir": None,
    },
    "generator": {"n_filters": 64, "n_layers": 8},
    # n_layers is accepted for schema parity with the reference but unused there
    # too (reference model.py:139-193 hardcodes the 7-block plan).
    "discriminator": {"n_filters": 64, "n_layers": 7},
    "training": {
        "compiled": True,  # jit is always on; kept for schema parity
        "pretrain_iterations": 100,
        "iterations": 100,
        "device": "cuda",
        "log_iter": 5000,
        "checkpoint_iter": 5000,
        "batch_size": 24,
        "num_workers": 16,
        "generator_lr": 1e-4,
        "discriminator_lr": 1e-4,
        # --- additions to the reference schema (the JAX package's) ---
        "bf16": True,  # bf16 compute (autocast), fp32 params/optimizer
        # torchvision vgg19 .pth path (the reference recipe); "pixel" opts
        # into SmoothL1 content loss; "init" runs random-VGG (profiling).
        # null + a GAN phase fails at startup (see train/steps.py).
        "vgg_weights": None,
        # the JAX package's training options (fast_srgan_tpu/config.py
        # documents them; train/steps.py runs each)
        "remat": False,
        "grad_accum": 1,
        "gan_shared_forward": True,
        "remat_vgg": False,
        "vgg_concat": False,
        "grad_clip": 0.0,
        "lr_schedule": None,
        "lr_decay_steps": [],
        "lr_decay_factor": 0.5,
        "lr_min_ratio": 0.1,
        "augment": False,
        "ema_decay": 0.0,
        # read by the trainers (train/trainer.py)
        "resume": True,
        "checkpoint_dir": None,
        "keep_checkpoints": 5,
        "export_pt": False,
        "init_generator_pt": None,
        "init_generator_optim_pt": None,
    },
    # training's devices: the port's trainer runs on one device (num_devices
    # > 1 and multihost raise); serving spreads over devices by its own
    # arguments (the engine's mesh=, infer --tile / inference.tile)
    "parallel": {
        "data_axis": "data",
        "num_devices": None,
        "scale_lr": False,
        "multihost": False,
    },
    "kernels": {
        # the JAX package's switch for its Pallas kernels; the port ignores
        # it and picks each kernel or its plain version by the tensor's device
        "use_pallas": False,
        # the fused conv + shuffle + PReLU kernel for each upsample stage
        "fused_upsample": False,
    },
    # Defaults for the infer CLIs' flags (a flag given on the command line
    # wins; python -m fast_srgan_torch.infer reads tile and bucket).
    # Semantics match the flags exactly: tile = shard each frame's
    # width across N devices (exact halo tiling); bucket = LR bucket
    # granularity in pixels (exact masked forward; 0 = one program per
    # distinct shape).
    "inference": {
        "tile": 0,
        "batch_size": 8,
        "bucket": 0,
    },
}


def _merge(base: dict, override: Mapping) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        elif v is None and isinstance(out.get(k), dict):
            # a bare section header (`kernels:` with every key commented
            # out) safe_loads to None; OmegaConf treats it as an empty
            # section — keep the defaults rather than nulling the section
            continue
        else:
            out[k] = copy.deepcopy(v)
    return out


def _coerce(value: Any) -> Any:
    """Convert YAML-1.1 stringly numbers (`1e-4`) to real numbers."""
    if isinstance(value, str) and _NUMERIC_RE.match(value):
        try:
            f = float(value)
            return int(f) if f.is_integer() and "." not in value and "e" not in value.lower() else f
        except ValueError:
            return value
    return value


def _coerce_tree(node: Any) -> Any:
    if isinstance(node, Mapping):
        return {k: _coerce_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_coerce_tree(v) for v in node]
    return _coerce(node)


def _parse_value(text: str) -> Any:
    """Parse an override value with YAML typing (`1e-4` -> float, etc.)."""
    import yaml

    try:
        return _coerce(yaml.safe_load(text))
    except yaml.YAMLError:
        return text


def apply_overrides(config: ConfigNode, overrides: Iterable[str]) -> ConfigNode:
    """Apply hydra-style ``a.b.c=value`` overrides in place.

    Hydra semantics for unknown keys: overriding a path that does not exist
    in the config is an error (a typo would otherwise silently train with
    defaults); prefix with ``+`` to add a new key, and ``hydra.*`` keys are
    always accepted (the reference exposes e.g. ``hydra.run.dir`` —
    train.py honors it by chdir'ing, matching Hydra 1.1).
    """
    for item in overrides:
        if "=" not in item:
            raise ValueError(
                f"Override {item!r} is not of the form key.path=value"
            )
        path, _, raw = item.partition("=")
        stripped = path.strip()
        additive = stripped.startswith("+") or stripped.startswith("hydra.")
        keys = stripped.lstrip("+").split(".")
        node: Any = config
        for key in keys[:-1]:
            if key not in node or not isinstance(node[key], ConfigNode):
                if not additive:
                    raise KeyError(
                        f"Unknown config section {key!r} in override "
                        f"{item!r} (prefix with '+' to add new keys)"
                    )
                node[key] = ConfigNode()
            node = node[key]
        if not additive and keys[-1] not in node:
            raise KeyError(
                f"Unknown config key {stripped!r} in override {item!r} "
                "(prefix with '+' to add new keys)"
            )
        node[keys[-1]] = _parse_value(raw)
    return config


def load_config(
    path: str | None = None,
    overrides: Iterable[str] = (),
    required: bool = False,
) -> ConfigNode:
    """Load YAML config, merge over defaults, apply dotted overrides.

    ``required=True`` makes a missing ``path`` an error — CLIs pass it for
    user-supplied --config values so a typo'd path cannot silently run on
    pure defaults; the default stays lenient for the bundled-config case.
    """
    data: dict = {}
    if path is not None and not os.path.exists(path):
        if required:
            raise FileNotFoundError(f"config file not found: {path!r}")
    elif path is not None:
        import yaml

        with open(path) as f:
            data = _coerce_tree(yaml.safe_load(f) or {})
    config = ConfigNode(_merge(DEFAULTS, data))
    apply_overrides(config, overrides)
    return config


def default_config(**sections) -> ConfigNode:
    """Programmatic config (tests): defaults with per-section dict updates."""
    return ConfigNode(_merge(DEFAULTS, sections))
