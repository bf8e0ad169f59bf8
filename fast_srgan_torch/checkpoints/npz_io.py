"""The native ``.npz`` checkpoint: a '/'-flattened generator param tree.

Every leaf is stored under its '/'-joined tree path, e.g.
``params/neck_conv/kernel`` (HWIO, fp32). numpy only, so it runs wherever
the port does. The counterpart of ``fast_srgan_tpu/checkpoints/npz_io.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a': {'b': {'c': leaf}}} -> {'a/b/c': leaf as a numpy array}."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(flatten_tree(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """{'a/b/c': leaf} -> {'a': {'b': {'c': leaf}}}."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def load_npz_params(path: str) -> Dict[str, Any]:
    """Read a param tree; always returns the {'params': ...} wrapper."""
    with np.load(path) as npz:
        tree = unflatten_tree({k: npz[k] for k in npz.files})
    return tree if "params" in tree else {"params": tree}


def save_npz_params(path: str, params: Dict[str, Any]) -> None:
    """Write a param tree (with or without the 'params' wrapper) to ``path``
    as it is named: an explicit file, since ``np.savez`` on a path string
    appends '.npz' to a name without it."""
    tree = params if "params" in params else {"params": params}
    with open(path, "wb") as f:
        np.savez(f, **flatten_tree(tree))
