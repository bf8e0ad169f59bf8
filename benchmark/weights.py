"""The weights both sides are handed: the published generator from its
``.npz``, read once and given to the program and to the reference."""

from __future__ import annotations

from typing import Dict

import numpy as np


def load_npz_tree(path: str) -> Dict:
    """A '/'-flattened ``.npz`` as a nested dict of numpy arrays."""
    tree: Dict = {}
    with np.load(path) as npz:
        for key in npz.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = npz[key]
    return tree if "params" in tree else {"params": tree}
