"""The FPGA export bundle: ``.bin`` files, scales, ``metadata.json`` and
CRC32s (counterpart of ``ofdmgan_tpu/quant/export.py``), byte for byte the
reference's:

* ``<layer>_weights.bin``: per-output-channel symmetric int8 weights,
  flattened ``[out, in, k]`` for a conv and ``[out, in]`` for the dense layer;
* ``<layer>_scale.bin``: the float32 per-channel scales;
* ``<layer>_bias.bin``: float32 biases, or int32 Q16.16 with
  ``write_bias_format="int32_q1616"`` (the reference's writer and its ROM
  reader disagree on this format; both are kept);
* ``metadata.json`` with the reference's keys, in its order.

Layer names are the reference's: ``enc1.conv``, ``bottleneck.conv``,
``dec1.conv``, ``out_conv`` for the mini generator (dots become
underscores in file names), ``conv1``, ``conv2``, ``dense`` for the critic,
``enc1_1`` ... ``final`` for the full U-Net. Every function takes a model of
the port or a flax-layout parameter tree (a ``.npz`` champion read by
``utils.params_io.load_params_tree``); a model is read through the weight
bridge, so both give the same bytes. The arithmetic is numpy on the host.
"""

from __future__ import annotations

import binascii
import json
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
from torch import nn

from ..models.full_unet import full_unet_layer_names
from ..utils.jax_params import to_jax_params
from ..utils.params_io import flatten_tree, load_params_tree


class LayerSpec(NamedTuple):
    name: str            # the reference's dotted name
    kind: str            # "Conv1d" | "Linear"
    weight: np.ndarray   # conv: [out, in, k]; linear: [out, in]
    bias: Optional[np.ndarray]
    stride: int = 1
    padding: int = 1


def _flatten_params(params) -> Dict[tuple, np.ndarray]:
    """A model or a flax tree -> ``{path tuple under "params": array}``."""
    tree = to_jax_params(params) if isinstance(params, nn.Module) else params
    tree = tree.get("params", tree)
    return {tuple(k.split("/")): np.asarray(v) for k, v in flatten_tree(tree).items()}


def _conv_wb(flat: Dict[tuple, np.ndarray], scope: tuple):
    """(kernel as ``[out, in, k]``, bias) of the conv at ``scope``, under any
    of the reference's parameter namings."""
    for wkey, bkey in ((scope + ("conv_kernel",), scope + ("conv_bias",)),
                       (scope + ("conv", "kernel"), scope + ("conv", "bias")),
                       (scope[:-1] + (scope[-1] + "_kernel",), scope[:-1] + (scope[-1] + "_bias",)),
                       (scope + ("kernel",), scope + ("bias",))):
        if wkey in flat:
            return np.transpose(flat[wkey], (2, 1, 0)), flat[bkey]
    raise KeyError(f"no conv params under {scope}")


def generator_layers(params) -> List[LayerSpec]:
    """The mini generator's layers in the reference's order."""
    flat = _flatten_params(params)
    return [
        LayerSpec("enc1.conv", "Conv1d", *_conv_wb(flat, ("enc1",)), stride=2),
        LayerSpec("bottleneck.conv", "Conv1d", *_conv_wb(flat, ("bottleneck",)), stride=2),
        LayerSpec("dec1.conv", "Conv1d", *_conv_wb(flat, ("dec1",)), stride=1),
        LayerSpec("out_conv", "Conv1d", *_conv_wb(flat, ("out_conv",)), stride=1),
    ]


def discriminator_layers(params) -> List[LayerSpec]:
    flat = _flatten_params(params)
    return [
        LayerSpec("conv1", "Conv1d", *_conv_wb(flat, ("conv1",)), stride=2),
        LayerSpec("conv2", "Conv1d", *_conv_wb(flat, ("conv2",)), stride=2),
        LayerSpec("dense", "Linear", flat[("dense", "kernel")].T, flat[("dense", "bias")],
                  stride=1, padding=0),
    ]


def crc32_hex(data: bytes) -> str:
    return f"{binascii.crc32(data) & 0xFFFFFFFF:08x}"


def quantize_layer_int8(weight: np.ndarray, weight_bits: int = 8, per_channel: bool = True):
    """Symmetric int8 quantization, per output channel (axis 0) or per
    tensor -> (int8 weights, float32 scales)."""
    w = np.asarray(weight)
    max_q = 2 ** (weight_bits - 1) - 1
    if per_channel:
        abs_max = np.abs(w).max(axis=tuple(range(1, w.ndim)), keepdims=True)
    else:
        abs_max = np.abs(w).max()
    scale = np.maximum(abs_max, 1e-8) / max_q
    q = np.clip(np.round(w / scale), -(max_q + 1), max_q)
    return q.astype(np.int8), np.asarray(scale, np.float32).squeeze()


CONV_KEYS = ("type", "weight_file", "scale_file", "bias", "weight_shape", "kernel_size",
             "stride", "padding", "in_channels", "out_channels", "crc32")
LINEAR_KEYS = ("type", "weight_file", "scale_file", "bias", "weight_shape", "in_features",
               "out_features", "crc32")


def export_weights(layers: List[LayerSpec], output_dir: str, weight_bits: int = 8,
                   activation_bits: int = 16, per_channel: bool = True,
                   write_bias_format: str = "float32") -> Dict[str, Any]:
    """Write the bundle of ``layers`` into ``output_dir``; returns the
    metadata (also written to ``metadata.json``)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    metadata: Dict[str, Any] = {
        "config": {"weight_bits": weight_bits, "activation_bits": activation_bits,
                   "per_channel": per_channel},
        "layers": {},
    }
    for layer in layers:
        base = layer.name.replace(".", "_")
        w_int8, scale = quantize_layer_int8(layer.weight, weight_bits, per_channel)
        wfile, sfile = f"{base}_weights.bin", f"{base}_scale.bin"
        w_int8.flatten().tofile(out / wfile)
        np.asarray(scale, np.float32).tofile(out / sfile)
        bias_info = None
        if layer.bias is not None:
            bfile = f"{base}_bias.bin"
            if write_bias_format == "float32":
                layer.bias.astype(np.float32).tofile(out / bfile)
            elif write_bias_format == "int32_q1616":
                q = np.clip(np.round(layer.bias * 65536.0), -(2 ** 31), 2 ** 31 - 1)
                q.astype(np.int32).tofile(out / bfile)
            else:
                raise ValueError(write_bias_format)
            bias_info = {"file": bfile, "shape": list(layer.bias.shape)}
        shape = layer.weight.shape
        info: Dict[str, Any] = {"type": layer.kind, "weight_file": wfile, "scale_file": sfile,
                                "bias": bias_info, "weight_shape": list(shape),
                                "crc32": crc32_hex(w_int8.flatten().tobytes())}
        if layer.kind == "Conv1d":
            info.update(kernel_size=shape[2], stride=layer.stride, padding=layer.padding,
                        in_channels=shape[1], out_channels=shape[0])
            keys = CONV_KEYS
        else:
            info.update(in_features=shape[1], out_features=shape[0])
            keys = LINEAR_KEYS
        metadata["layers"][layer.name] = {k: info[k] for k in keys}
    with open(out / "metadata.json", "w") as f:
        json.dump(metadata, f, indent=2)
    return metadata


def export_generator(params, output_dir: str, **kw) -> Dict[str, Any]:
    """The mini generator's bundle."""
    return export_weights(generator_layers(params), output_dir, **kw)


def export_discriminator(params, output_dir: str, **kw) -> Dict[str, Any]:
    """The mini critic's bundle."""
    return export_weights(discriminator_layers(params), output_dir, **kw)


def full_unet_layers(params, levels: int = 0) -> List[LayerSpec]:
    """The full U-Net generator's layers under the reference's export names
    (``enc1_1`` ... ``final``); ``levels`` 0 reads the depth from the
    parameters."""
    flat = _flatten_params(params)
    if not levels:
        levels = max(int(name[3]) for name, _ in flat if name.startswith("enc"))
    specs = []
    for name in full_unet_layer_names(levels):
        stride = 2 if name.startswith("enc") and name.endswith("_1") else 1
        specs.append(LayerSpec(name, "Conv1d", np.transpose(flat[(name, "kernel")], (2, 1, 0)),
                               flat[(name, "bias")], stride=stride, padding=1))
    return specs


def export_full_unet(params, output_dir: str, levels: int = 0, **kw) -> Dict[str, Any]:
    """The full U-Net generator's bundle: the file set of the reference's
    ``export/generator/``."""
    return export_weights(full_unet_layers(params, levels), output_dir, **kw)


def export_any_generator(params, output_dir: str, **kw) -> Dict[str, Any]:
    """The bundle of a mini or a full U-Net generator, chosen by its
    parameters (the full family has ``enc1_1``)."""
    flat = _flatten_params(params)
    if ("enc1_1", "kernel") in flat:
        return export_full_unet(params, output_dir, **kw)
    return export_generator(params, output_dir, **kw)


def export_generator_checkpoint(path: str, export_dir: str, **kw) -> Dict[str, Any]:
    """The bundle of a checkpoint directory's generator (its ``params_g.npz``)
    or of a generator ``.npz``, written to ``export_dir/generator``."""
    if not path or not Path(path).exists():
        raise FileNotFoundError(f"no generator checkpoint at {path!r}: give a checkpoint "
                                "directory (its params_g.npz) or a generator .npz")
    return export_any_generator(load_params_tree(path), str(Path(export_dir) / "generator"),
                                **kw)
