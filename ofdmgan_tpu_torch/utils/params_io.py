"""``.npz`` parameter files in the JAX package's format.

Keys are ``/``-joined tree paths (``params/enc1/conv_kernel``), values numpy
arrays in flax layout: the format of ``ofdmgan_tpu/utils/params_io.py:22``
and of the committed ``champion_params_g.npz`` files.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_tree(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        node, keys = tree, path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(arr)
    return tree


def load_params_tree(path: str) -> Dict[str, Any]:
    """Nested numpy tree from an ``.npz`` file."""
    with np.load(path) as flat:
        return unflatten_tree(dict(flat.items()))


def save_params_tree(path: str, tree: Dict[str, Any]) -> None:
    np.savez(path, **flatten_tree(tree))
