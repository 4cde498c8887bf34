"""Weight bridge between flax parameter trees and torch ``state_dict``s.

Key tables cover the mini pair (``MiniGenerator``, ``MiniDiscriminator``)
and the full U-Net family at any depth (``FullUNetGenerator``:
``params/<layer>/{kernel,bias}`` for each of ``full_unet_layer_names``;
``FullDiscriminator``: ``params/conv<i>/...`` and ``params/dense/...``).
``from_jax_params`` picks the table by the flax paths, which differ
between the families; ``to_jax_params`` takes the module and picks it by
the module's type (a two-level full critic has the mini critic's torch
keys).
Conv kernels are flax ``[K, C_in, C_out]`` and torch ``[C_out, C_in, K]``;
the dense kernel is flax ``[in, out]`` and torch ``[out, in]``. Both maps are
transposes, so each direction is the inverse of the other (and of
``ofdmgan_tpu/utils/torch_port.py:17-19``). The QAT helpers of
``quant/fakequant.py`` carry their running max as the flax tree's
``batch_stats`` (``FakeQuantize``'s ``running_max`` buffer). The simpleGAN's parameters are
a ``NamedTuple`` of eight arrays in both packages, in the same layout
(``simplegan_from_numpy``, ``simplegan_to_numpy``).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..models import MiniDiscriminator, MiniGenerator
from ..models.full_unet import FullDiscriminator, FullUNetGenerator, full_unet_layer_names
from ..quant.fakequant import FakeQuantize, QuantizedConv1d
from ..simplegan.model import SimpleGANParams
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


# the QAT helpers: parameters under "params", FakeQuantize's running max
# under "batch_stats" (the reference's flax collections)
QUANTIZED_CONV_KEYS = {"weight": "params/kernel", "bias": "params/bias",
                       "act_q.running_max": "batch_stats/act_q/running_max"}
FAKE_QUANTIZE_KEYS = {"running_max": "batch_stats/running_max"}


def _swap_layout(a: np.ndarray) -> np.ndarray:
    """flax <-> torch layout of one array (self-inverse)."""
    if a.ndim == 3:
        return np.ascontiguousarray(np.transpose(a, (2, 1, 0)))
    if a.ndim == 2:
        return np.ascontiguousarray(a.T)
    return np.ascontiguousarray(a)


def _layer_keys(layers) -> Dict[str, str]:
    return {f"{layer}.{t}": f"params/{layer}/{f}" for layer in layers
            for t, f in (("weight", "kernel"), ("bias", "bias"))}


def full_generator_keys(levels: int) -> Dict[str, str]:
    """The table of a ``levels``-deep ``FullUNetGenerator``."""
    return _layer_keys(full_unet_layer_names(levels))


def full_critic_keys(levels: int) -> Dict[str, str]:
    """The table of a ``levels``-deep ``FullDiscriminator``."""
    return _layer_keys([f"conv{i+1}" for i in range(levels)] + ["dense"])


def _depth(paths, pattern: str) -> int:
    """The number of distinct layers ``pattern`` (with one group: the level) matches."""
    return len({m.group(1) for p in paths if (m := re.fullmatch(pattern, p))})


def _keys_for(paths) -> Dict[str, str]:
    """The table whose flax paths are exactly ``paths``."""
    paths = set(paths)
    tables = (GENERATOR_KEYS, CRITIC_KEYS, QUANTIZED_CONV_KEYS, FAKE_QUANTIZE_KEYS,
              full_generator_keys(_depth(paths, r"params/enc(\d+)_1/kernel")),
              full_critic_keys(_depth(paths, r"params/conv(\d+)/kernel")))
    for table in tables:
        if paths == set(table.values()):
            return table
    raise ValueError(f"not a tree of the mini pair or the full U-Net family: {sorted(paths)}")


def keys_of(module: nn.Module) -> Dict[str, str]:
    """The key table of a model of the port, by its type."""
    if isinstance(module, MiniGenerator):
        return GENERATOR_KEYS
    if isinstance(module, MiniDiscriminator):
        return CRITIC_KEYS
    if isinstance(module, FullUNetGenerator):
        return full_generator_keys(module.levels)
    if isinstance(module, FullDiscriminator):
        return full_critic_keys(module.levels)
    if isinstance(module, QuantizedConv1d):
        return QUANTIZED_CONV_KEYS
    if isinstance(module, FakeQuantize):
        return FAKE_QUANTIZE_KEYS
    raise ValueError(f"no JAX key table for {type(module).__name__}")


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax tree (numpy leaves) -> torch float32 ``state_dict``."""
    flat = flatten_tree(tree)
    table = _keys_for(flat)
    return {k: torch.from_numpy(_swap_layout(np.array(flat[p], np.float32)))
            for k, p in table.items()}


def to_jax_params(module: nn.Module) -> Dict[str, Any]:
    """A model of the port -> flax tree with numpy float32 leaves."""
    table, state_dict = keys_of(module), module.state_dict()
    return unflatten_tree({
        p: _swap_layout(state_dict[k].detach().cpu().numpy().astype(np.float32))
        for k, p in table.items()})


def simplegan_from_numpy(arrays, device=None) -> SimpleGANParams:
    """The JAX package's ``SimpleGANParams`` (or any sequence of its eight
    arrays in field order) -> the port's, float32 tensors on ``device``."""
    return SimpleGANParams(*(torch.as_tensor(np.array(a, np.float32), device=device)
                             for a in arrays))


def simplegan_to_numpy(params: SimpleGANParams) -> Dict[str, np.ndarray]:
    """The port's ``SimpleGANParams`` -> float32 numpy arrays by field name
    (``ofdmgan_tpu.simplegan.SimpleGANParams(**...)`` takes them)."""
    return {f: t.detach().cpu().numpy().astype(np.float32)
            for f, t in zip(params._fields, params)}
