"""Conditional Wasserstein critic and gradient penalty (counterpart of
``ofdmgan_tpu/models/critic.py:32-118``).

    concat(candidate [B,L,2], condition [B,L,2]) -> conv1 (4->8, k3, s2)
    -> LeakyReLU -> conv2 (8->16, k3, s2) -> LeakyReLU
    -> sum over time -> dense (16 -> 1)

521 parameters, no normalisation, sum pooling in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .generator import _conv


class MiniDiscriminator(nn.Module):
    def __init__(self, input_channels: int = 4, conv1_channels: int = 8,
                 conv2_channels: int = 16, leaky_slope: float = 0.2):
        super().__init__()
        self.leaky_slope = leaky_slope
        self.conv1 = _conv(input_channels, conv1_channels, 2)
        self.conv2 = _conv(conv1_channels, conv2_channels, 2)
        self.dense = nn.Linear(conv2_channels, 1)
        nn.init.xavier_uniform_(self.dense.weight)
        nn.init.zeros_(self.dense.bias)

    def forward(self, candidate: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        """``[B, L, 2] x [B, L, 2] -> [B, 1]`` critic score."""
        h = torch.cat([candidate, condition], dim=-1).transpose(1, 2)
        h = F.leaky_relu(self.conv1(h), self.leaky_slope)
        h = F.leaky_relu(self.conv2(h), self.leaky_slope)
        return self.dense(h.sum(dim=-1))


def compute_gradient_penalty(critic: nn.Module, real: torch.Tensor, fake: torch.Tensor,
                             condition: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """E[(||∇_x D(x, c)||_2 - 1)^2] at x = alpha·real + (1-alpha)·fake.

    ``alpha`` ``[B]`` is one uniform per sample, drawn by the caller (the
    reference draws it at ``critic.py:95``). The graph is kept, so the
    penalty's own parameter gradient is second order.
    """
    a = alpha.reshape(-1, *([1] * (real.ndim - 1)))
    interp = (a * real + (1.0 - a) * fake).detach().requires_grad_(True)
    score = critic(interp, condition).sum()
    (grads,) = torch.autograd.grad(score, interp, create_graph=True)
    norms = torch.sqrt((grads.reshape(grads.shape[0], -1) ** 2).sum(dim=1) + 1e-12)
    return ((norms - 1.0) ** 2).mean()
