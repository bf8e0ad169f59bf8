"""Read the native ``.npz`` checkpoint: a '/'-flattened generator param tree.

Every leaf is stored under its '/'-joined tree path, e.g.
``params/neck_conv/kernel`` (HWIO, fp32). numpy only, so the reader runs
wherever the port does.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


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
