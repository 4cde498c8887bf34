"""Conditional Wasserstein critic and gradient penalty (counterpart of
``ofdmgan_tpu/models/critic.py:32-118``).

    concat(candidate [B,L,2], condition [B,L,2]) -> conv1 (4->8, k3, s2)
    -> LeakyReLU -> conv2 (8->16, k3, s2) -> LeakyReLU
    -> sum over time -> dense (16 -> 1)

521 parameters, no normalisation, sum pooling in float32. ``act_dtype``
stores conv1's activation in that format (reference ``critic.py:39-60``);
inputs in a storage format are read upcast to float32. A ``conv_fn`` given
to ``forward`` computes each convolution (``generator.apply_conv``), and
``pool`` takes the sum over length further (across the processes that hold
the frame's other pieces), as the full critic's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .generator import FP8_DTYPES, _conv, apply_conv, as_dtype, read_stored, storage_dtype


class MiniDiscriminator(nn.Module):
    def __init__(self, input_channels: int = 4, conv1_channels: int = 8,
                 conv2_channels: int = 16, leaky_slope: float = 0.2, act_dtype=None):
        super().__init__()
        self.leaky_slope = leaky_slope
        self.act_dtype = storage_dtype(act_dtype)
        self.conv1 = _conv(input_channels, conv1_channels, 2)
        self.conv2 = _conv(conv1_channels, conv2_channels, 2)
        self.dense = nn.Linear(conv2_channels, 1)
        nn.init.xavier_uniform_(self.dense.weight)
        nn.init.zeros_(self.dense.bias)

    def forward(self, candidate: torch.Tensor, condition: torch.Tensor, conv_fn=None,
                pool=None) -> torch.Tensor:
        """``[B, L, 2] x [B, L, 2] -> [B, 1]`` critic score."""
        dt = self.conv1.weight.dtype
        if candidate.dtype == condition.dtype:   # read by the conv, fp8 through bf16
            pair = [read_stored(candidate, dt), read_stored(condition, dt)]
        else:   # a mixed call is promoted first, fp8 straight to float32 (critic.py:41-49)
            pair = [as_dtype(candidate, dt), as_dtype(condition, dt)]
        h = torch.cat(pair, dim=-1).transpose(1, 2)
        h = F.leaky_relu(apply_conv(self.conv1, "conv1", h, conv_fn), self.leaky_slope)
        if self.act_dtype is not None:
            h = h.to(self.act_dtype)
        h = F.leaky_relu(apply_conv(self.conv2, "conv2", read_stored(h, dt), conv_fn),
                         self.leaky_slope)
        pooled = as_dtype(h, torch.float32).sum(dim=-1)
        return self.dense(pooled if pool is None else pool(pooled))


def compute_gradient_penalty(critic: nn.Module, real: torch.Tensor, fake: torch.Tensor,
                             condition: torch.Tensor, alpha: torch.Tensor,
                             frame_sum=None) -> torch.Tensor:
    """E[(||∇_x D(x, c)||_2 - 1)^2] at x = alpha·real + (1-alpha)·fake.

    ``alpha`` ``[B]`` is one uniform per sample, drawn by the caller (the
    reference draws it at ``critic.py:95``). The graph is kept, so the
    penalty's own parameter gradient is second order. As in the reference,
    the interpolate is kept in ``real``'s storage dtype, so its gradient
    arrives rounded to that format; an fp8 gradient is upcast before the
    norm is summed. ``frame_sum(t)`` sums each frame's ``[B, ...]`` entries
    where a frame is split across processes (sequence parallelism); by
    default the frame is whole here.
    """
    a = alpha.reshape(-1, *([1] * (real.ndim - 1)))
    f32 = torch.float32
    interp = as_dtype(a * as_dtype(real, f32) + (1.0 - a) * as_dtype(fake, f32), real.dtype)
    interp = interp.detach().requires_grad_(True)
    score = critic(interp, condition).sum()
    (grads,) = torch.autograd.grad(score, interp, create_graph=True)
    if grads.dtype in FP8_DTYPES:
        grads = grads.float()
    sq = grads ** 2
    sq = sq.reshape(sq.shape[0], -1).sum(dim=1) if frame_sum is None else frame_sum(sq)
    norms = torch.sqrt(sq + 1e-12)
    return ((norms - 1.0) ** 2).mean()
