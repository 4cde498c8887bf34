"""Quantization-aware training: straight-through fake quantization
(counterpart of ``ofdmgan_tpu/quant/fakequant.py``).

The forward pass sees ``dequantize(quantize(x))``, the backward pass the
identity. It is written ``x + (q - x).detach()``, the reference's
expression, so that forward values match it bit for bit (``q`` alone can
differ from it in the last place).
"""

from __future__ import annotations

import torch

from .qformat import compute_scale, dequantize, quantize


def fake_quantize(x: torch.Tensor, scale, n_bits: int) -> torch.Tensor:
    q = dequantize(quantize(x, scale, n_bits), scale)
    return x + (q - x).detach()


def fake_quantize_auto(x: torch.Tensor, n_bits: int, per_channel: bool = False,
                       channel_axis: int = 0) -> torch.Tensor:
    """Fake quantization with the scale taken from ``x`` itself, outside
    the gradient (the weight path: a new scale at every step)."""
    with torch.no_grad():
        scale = compute_scale(x, n_bits, per_channel, channel_axis)
    return fake_quantize(x, scale, n_bits)
