"""Weight bridge between flax parameter trees and torch ``state_dict``s.

Conv kernels are flax ``[K, C_in, C_out]`` and torch ``[C_out, C_in, K]``;
the dense kernel is flax ``[in, out]`` and torch ``[out, in]``. Both maps are
transposes, so each direction is the inverse of the other (and of
``ofdmgan_tpu/utils/torch_port.py:17-19``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .params_io import flatten_tree, unflatten_tree

# torch state_dict key -> flax tree path, for MiniGenerator and MiniDiscriminator
GENERATOR_KEYS = {
    "enc1.weight": "params/enc1/conv_kernel",
    "enc1.bias": "params/enc1/conv_bias",
    "bottleneck.weight": "params/bottleneck/conv_kernel",
    "bottleneck.bias": "params/bottleneck/conv_bias",
    "dec1.weight": "params/dec1/conv_kernel",
    "dec1.bias": "params/dec1/conv_bias",
    "out_conv.weight": "params/out_conv_kernel",
    "out_conv.bias": "params/out_conv_bias",
}
CRITIC_KEYS = {
    "conv1.weight": "params/conv1_kernel",
    "conv1.bias": "params/conv1_bias",
    "conv2.weight": "params/conv2_kernel",
    "conv2.bias": "params/conv2_bias",
    "dense.weight": "params/dense/kernel",
    "dense.bias": "params/dense/bias",
}


def _swap_layout(a: np.ndarray) -> np.ndarray:
    """flax <-> torch layout of one array (self-inverse)."""
    if a.ndim == 3:
        return np.ascontiguousarray(np.transpose(a, (2, 1, 0)))
    if a.ndim == 2:
        return np.ascontiguousarray(a.T)
    return np.ascontiguousarray(a)


def _keys_for(paths) -> Dict[str, str]:
    for table in (GENERATOR_KEYS, CRITIC_KEYS):
        if set(paths) == set(table.values()) or set(paths) == set(table):
            return table
    raise ValueError(f"not a MiniGenerator or MiniDiscriminator tree: {sorted(paths)}")


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax tree (numpy leaves) -> torch float32 ``state_dict``."""
    flat = flatten_tree(tree)
    table = _keys_for(flat)
    return {k: torch.from_numpy(_swap_layout(np.array(flat[p], np.float32)))
            for k, p in table.items()}


def to_jax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """torch ``state_dict`` -> flax tree with numpy float32 leaves."""
    table = _keys_for(state_dict)
    return unflatten_tree({
        p: _swap_layout(state_dict[k].detach().cpu().numpy().astype(np.float32))
        for k, p in table.items()})
