"""``.npz`` parameter files in the JAX package's format.

Keys are ``/``-joined tree paths (``params/enc1/conv_kernel``), values numpy
arrays in flax layout: the format of ``ofdmgan_tpu/utils/params_io.py:22``
and of the committed ``champion_params_g.npz`` files. ``load_params_tree``
also takes a checkpoint directory of the port (its ``params_g.npz``, or
``ema_params_g.npz``); the JAX package's Orbax directories need orbax,
which the port does not use: ``scripts/extract_champion.py`` turns one into
a flat ``.npz``.
"""

from __future__ import annotations

from pathlib import Path
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


def load_params_tree(path: str, ema: bool = False) -> Dict[str, Any]:
    """Nested numpy tree from an ``.npz`` file, or a checkpoint directory's
    generator (``ema``: its EMA generator)."""
    src = Path(path)
    if src.is_dir():
        name = "ema_params_g.npz" if ema else "params_g.npz"
        if not (src / name).is_file():
            if not (src / "params_g.npz").is_file():
                raise FileNotFoundError(
                    f"{path} holds no params_g.npz: not a checkpoint of this package (an "
                    "Orbax checkpoint of the JAX package? turn it into a flat .npz with "
                    "scripts/extract_champion.py)")
            raise FileNotFoundError(f"{path} holds no {name}: the run kept no EMA")
        src = src / name
    elif ema:
        raise SystemExit(
            f"--ema has no effect on flat .npz artifacts ({path}): extract "
            "the EMA subtree first with scripts/extract_champion.py --ema")
    with np.load(src) as flat:
        return unflatten_tree(dict(flat.items()))


def save_params_tree(path: str, tree: Dict[str, Any]) -> None:
    np.savez(path, **flatten_tree(tree))
