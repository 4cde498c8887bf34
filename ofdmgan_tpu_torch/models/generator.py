"""Mini 1-D U-Net generator (counterpart of
``ofdmgan_tpu/models/generator.py:123-199``).

    [B, L, 2] -> enc1 (2->4, k3, s2) -> bottleneck (4->8, k3, s2)
    -> upsample x2 -> dec1 (8->4, k3, s1) -> + enc1
    -> upsample x2 -> out_conv (4->2, k3, s1) -> tanh | + input

LeakyReLU(0.2) after every conv but the last, Xavier-uniform weights, zero
biases, 258 parameters. ``input_residual`` selects the residual head
``y = x + out_conv(...)`` in place of ``tanh``. The reference's
``rtl_faithful`` and ``qat`` modes are not ported yet and raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _conv(cin: int, cout: int, stride: int) -> nn.Conv1d:
    conv = nn.Conv1d(cin, cout, 3, stride=stride, padding=1)
    nn.init.xavier_uniform_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


def count_parameters(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


class MiniGenerator(nn.Module):
    def __init__(self, input_channels: int = 2, output_channels: int = 2,
                 enc1_channels: int = 4, bottleneck_channels: int = 8,
                 dec1_channels: int = 4, leaky_slope: float = 0.2,
                 input_residual: bool = False, rtl_faithful: bool = False,
                 qat: bool = False):
        super().__init__()
        if rtl_faithful or qat:
            raise NotImplementedError("the rtl_faithful and qat modes are not ported yet")
        self.leaky_slope = leaky_slope
        self.input_residual = input_residual
        self.enc1 = _conv(input_channels, enc1_channels, 2)
        self.bottleneck = _conv(enc1_channels, bottleneck_channels, 2)
        self.dec1 = _conv(bottleneck_channels, dec1_channels, 1)
        self.out_conv = _conv(dec1_channels, output_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Noisy frames ``[B, L, 2]`` -> enhanced ``[B, L, 2]``."""
        act = lambda h: F.leaky_relu(h, self.leaky_slope)  # noqa: E731
        h = x.transpose(1, 2)
        enc1 = act(self.enc1(h))
        bneck = act(self.bottleneck(enc1))
        dec1 = act(self.dec1(bneck.repeat_interleave(2, dim=-1)))
        out = self.out_conv((dec1 + enc1).repeat_interleave(2, dim=-1)).transpose(1, 2)
        return x + out if self.input_residual else torch.tanh(out)
