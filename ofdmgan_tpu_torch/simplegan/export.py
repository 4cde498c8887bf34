"""simpleGAN fixed-point weight export and integer inference (counterpart
of ``ofdmgan_tpu/simplegan/export.py``).

* Weight text files: one ``<int> // <float:.10f>`` line per value,
  row-major; weights Q1.7 (round(x·128), int8), biases Q8.8 (round(x·256),
  int16), the format of LSI_Contest_simple_gan_3x3.m's weight extraction
  and of the reference's rtl/simpleGAN/model/gen_w1.txt. Each float32
  weight is written from its float64 value, as the JAX package does.
* Integer datapath, as int64 tensors on the device of the parameters:
  sequential dense y = Wx + b in Q format with a ``>>> 7`` requantization
  of each product and 256-entry activation LUTs (dense_layer.v,
  activation_tanh.v, activation_sigmoid.v):

  - tanh LUT: 256 entries over [0, 4) (index = Q8.8 value >> 2),
    sign-mirrored, saturating to tanh(4);
  - sigmoid LUT: 256 entries over [0, 8) (index = Q8.8 >> 3), mirrored by
    sigmoid(-x) = 1 - sigmoid(x).

  ``np.round`` and ``torch.round`` both round half to even, and ``>>`` of
  a signed int64 is arithmetic in both, so the integers equal the JAX
  package's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .model import SimpleGANParams

_FILES = [
    ("gen_w1.txt", "wg2", 7), ("gen_b1.txt", "bg2", 8),
    ("gen_w2.txt", "wg3", 7), ("gen_b2.txt", "bg3", 8),
    ("disc_w1.txt", "wd2", 7), ("disc_b1.txt", "bd2", 8),
    ("disc_w2.txt", "wd3", 7), ("disc_b2.txt", "bd3", 8),
]
_SHAPES = {"wg2": (3, 2), "bg2": (3,), "wg3": (9, 3), "bg3": (9,),
           "wd2": (3, 9), "bd2": (3,), "wd3": (1, 3), "bd3": (1,)}


def _limits(frac: int):
    width = 8 if frac == 7 else 16
    return -(2 ** (width - 1)), 2 ** (width - 1) - 1


def export_weights_txt(params: SimpleGANParams, output_dir: str) -> Dict[str, int]:
    """Write the eight text files into ``output_dir``; returns their line counts."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    counts = {}
    for fname, field, frac in _FILES:
        flat = getattr(params, field).detach().double().cpu().numpy().flatten()
        lo, hi = _limits(frac)
        with open(out / fname, "w") as f:
            for v in flat:   # numpy row-major == MATLAB matrix' (:)
                q = int(np.clip(np.round(v * (2**frac)), lo, hi))
                f.write(f"{q} // {v:.10f}\n")
        counts[fname] = len(flat)
    return counts


def load_weights_txt(input_dir: str, device=None) -> SimpleGANParams:
    """Read the fixed-point text files back (the reference's checked-in
    files too); returns the QUANTIZED float32 values (int / 2^frac) on
    ``device`` (the CPU where none is given)."""
    vals = {}
    for fname, field, frac in _FILES:
        ints = [int(line.split("//")[0].strip())
                for line in (Path(input_dir) / fname).read_text().splitlines() if line.strip()]
        arr = np.asarray(ints, np.float32).reshape(_SHAPES[field]) / (2**frac)
        vals[field] = torch.as_tensor(arr, device=device)
    return SimpleGANParams(**vals)


# ------------------------------------------------------------- integer path
_TANH_LUT = np.round(np.tanh(np.arange(256) * 4.0 / 256.0) * 256.0).astype(np.int64)
_SIGM_LUT = np.round(
    1.0 / (1.0 + np.exp(-np.arange(256) * 8.0 / 256.0)) * 256.0
).astype(np.int64)


def _lut(table: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(table, device=like.device)


def tanh_lut_q88(x_q88: torch.Tensor) -> torch.Tensor:
    """256-entry LUT tanh with sign mirror (activation_tanh.v semantics)."""
    x = x_q88.to(torch.int64)
    lut = _lut(_TANH_LUT, x)
    mag = x.abs()
    y = torch.where(mag >= 1024, lut[255], lut[torch.clamp(mag >> 2, max=255)])
    return torch.sign(x) * y


def sigmoid_lut_q88(x_q88: torch.Tensor) -> torch.Tensor:
    """256-entry LUT sigmoid using sigmoid(-x) = 1 - sigmoid(x)
    (activation_sigmoid.v semantics)."""
    x = x_q88.to(torch.int64)
    lut = _lut(_SIGM_LUT, x)
    mag = x.abs()
    y = torch.where(mag >= 2048, lut[255], lut[torch.clamp(mag >> 3, max=255)])
    return torch.where(x >= 0, y, 256 - y)


def _dense_int(x_q88: torch.Tensor, w_q17: torch.Tensor, b_q88: torch.Tensor) -> torch.Tensor:
    """Sequential-MAC dense layer with per-product >>>7 (dense_layer.v), on
    ``[..., in]`` -> ``[..., out]``."""
    prod = (x_q88.unsqueeze(-2) * w_q17) >> 7
    return torch.clamp(prod.sum(dim=-1) + b_q88, -32768, 32767)


def quantize_params(params: SimpleGANParams) -> Dict[str, torch.Tensor]:
    """float params -> per layer int64 (Q1.7 weight, Q8.8 bias) tensors on
    the parameters' device."""
    q = {}
    for _, field, frac in _FILES:
        lo, hi = _limits(frac)
        arr = getattr(params, field).detach().double()
        q[field] = torch.clamp(torch.round(arr * (2**frac)), lo, hi).to(torch.int64)
    return q


def generator_int_forward(qparams: Dict[str, torch.Tensor], ng_q88: torch.Tensor) -> torch.Tensor:
    """Integer simple-GAN generator: latent Q8.8 ``[..., 2]`` -> image Q8.8
    ``[..., 9]`` (simple_generator.v datapath)."""
    x = ng_q88.to(torch.int64)
    h = tanh_lut_q88(_dense_int(x, qparams["wg2"], qparams["bg2"]))
    return tanh_lut_q88(_dense_int(h, qparams["wg3"], qparams["bg3"]))


def discriminator_int_forward(qparams: Dict[str, torch.Tensor],
                              x_q88: torch.Tensor) -> torch.Tensor:
    """Integer simple-GAN critic: image Q8.8 ``[..., 9]`` -> probability
    Q8.8 ``[...]`` (simple_discriminator.v datapath; a 0-d tensor for one
    image, where the JAX package returns an int)."""
    x = x_q88.to(torch.int64)
    h = tanh_lut_q88(_dense_int(x, qparams["wd2"], qparams["bd2"]))
    return sigmoid_lut_q88(_dense_int(h, qparams["wd3"], qparams["bd3"]))[..., 0]
