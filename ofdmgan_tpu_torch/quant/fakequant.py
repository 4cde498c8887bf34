"""Quantization-aware training: straight-through fake quantization
(counterpart of ``ofdmgan_tpu/quant/fakequant.py``).

The forward pass sees ``dequantize(quantize(x))``, the backward pass the
identity. It is written ``x + (q - x).detach()``, the reference's
expression, so that forward values match it bit for bit (``q`` alone can
differ from it in the last place).

``FakeQuantize`` is the reference's stateful activation quantizer (a
running-max EMA, ``fakequant.py:35-58``): its state is the buffer
``running_max``, the reference's ``batch_stats`` collection
(``utils/jax_params.py`` carries it across). ``QuantizedConv1d`` is its QAT
conv (``fakequant.py:61-84``): int16-faked input activations, int8-faked
weights per output channel, channels-last ``[B, L, C]`` in and out.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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


class FakeQuantize(nn.Module):
    """Activation fake quantization with a running-max EMA. Training (the
    module's mode, or ``train``): the scale is the batch's own
    ``max|x| / (2^(n-1) - 1)`` and ``running_max`` moves toward that max by
    ``momentum``; evaluation: the scale is ``running_max``'s."""

    def __init__(self, n_bits: int = 16, momentum: float = 0.1):
        super().__init__()
        self.n_bits, self.momentum = n_bits, momentum
        self.register_buffer("running_max", torch.zeros(()))

    def forward(self, x: torch.Tensor, train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        max_q = 2 ** (self.n_bits - 1) - 1
        with torch.no_grad():
            if train:
                cur = x.detach().abs().max()
                self.running_max.copy_((1 - self.momentum) * self.running_max
                                       + self.momentum * cur)
            else:
                cur = self.running_max
            scale = torch.clamp(cur, min=1e-8) / max_q
        return fake_quantize(x, scale, self.n_bits)


class QuantizedConv1d(nn.Module):
    """A QAT conv: ``[B, L, in_channels] -> [B, L_out, features]``."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, weight_bits: int = 8, activation_bits: int = 16):
        super().__init__()
        self.stride, self.padding, self.weight_bits = stride, padding, weight_bits
        self.act_q = FakeQuantize(n_bits=activation_bits)
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None) -> torch.Tensor:
        x = self.act_q(x, train)
        w = fake_quantize_auto(self.weight, self.weight_bits, per_channel=True, channel_axis=0)
        return F.conv1d(x.transpose(1, 2), w, self.bias, self.stride,
                        self.padding).transpose(1, 2)
