"""The full U-Net's forward with the fused decoder, and the full critic's
forward, as functions over the modules' parameters (counterpart of
``ofdmgan_tpu/models/unet_infer.py:48-160``).

The module's decoder upsamples by repetition and then runs a k = 3 conv
over the doubled length. With u[2i] = u[2i+1] = h[i]:

    y[2i]   = w0*h[i-1] + (w1+w2)*h[i]
    y[2i+1] = (w0+w1)*h[i] + w2*h[i+1]

so the pair is exactly two k = 2 convs of the un-upsampled h, one for the
even and one for the odd outputs, interleaved: 8 instead of 12
C_in*C_out*L multiply-adds and no upsampled activation. The identity is
exact, hence differentiable, so the same function serves as the training
forward (``train.py --fused_decoder``); it differs from the module only in
that ``w1+w2`` and ``w0+w1`` are rounded before the products are summed.
The unfused forward is the module's own (``FullUNetGenerator.forward``);
the reference's ``fused_decoder=False`` has no counterpart here. The
reference's compile-time warning for this forward at float32 is a TPU
compiler matter: here it runs at float32 like any other forward. On the
H100 the fused forward trains slower than the module's (PERF.md section 5).

``act_dtype`` (float32 or bfloat16) casts the activations and the
operands, kernels and biases; the parameters themselves stay float32, so
their gradients arrive in float32 through the casts. A ``conv_fn(name, h,
weight, bias, stride, (left, right) padding)`` given to the generator's
apply computes each convolution, the two k = 2 halves of a fused
``dec*_1`` each under that layer's name (the tensor- and
sequence-parallel convolutions of ``parallel/gspmd.py``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .generator import conv1d_padded

_APPLY_DTYPES = (torch.float32, torch.bfloat16)


def _check_act_dtype(act_dtype: torch.dtype) -> None:
    if act_dtype not in _APPLY_DTYPES:
        raise ValueError(f"act_dtype must be float32 or bfloat16, not {act_dtype}")


def _conv(name: str, h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
          pads=(1, 1)) -> torch.Tensor:
    return conv1d_padded(h, w, b, stride, pads)


def _upconv_fused(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, conv=None,
                  name: str = "") -> torch.Tensor:
    """``upsample_nearest_2x`` then conv(k = 3, pad 1), as two interleaved
    k = 2 convs. ``w``: the ``dec*_1`` weight ``[C_out, C_in, 3]``."""
    conv = conv or _conv
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    even = conv(name, h, torch.stack([w0, w1 + w2], dim=-1), b, 1, (1, 0))
    odd = conv(name, h, torch.stack([w0 + w1, w2], dim=-1), b, 1, (0, 1))
    n, c, l = even.shape
    return torch.stack([even, odd], dim=-1).reshape(n, c, 2 * l)


def make_unet_infer_apply(levels: int = 5, leaky_slope: float = 0.2,
                          act_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``apply(generator, x, conv_fn=None) -> y`` over a
    ``FullUNetGenerator``'s parameters, through the fused k = 2-pair
    decoder."""
    _check_act_dtype(act_dtype)

    def apply(gen: nn.Module, x: torch.Tensor, conv_fn=None) -> torch.Tensor:
        conv = conv_fn or _conv

        def layer(name, h, stride=1):
            w = getattr(gen, name)
            return conv(name, h, w.weight.to(act_dtype), w.bias.to(act_dtype), stride, (1, 1))

        act = lambda h: F.leaky_relu(h, leaky_slope)  # noqa: E731
        h = x.to(act_dtype).transpose(1, 2)
        skips = []
        for i in range(levels):
            h = act(layer(f"enc{i+1}_1", h, stride=2))
            h = act(layer(f"enc{i+1}_2", h))
            skips.append(h)
        h = act(layer("bottle1", h))
        h = act(layer("bottle2", h))
        for i in range(levels):
            dec = getattr(gen, f"dec{i+1}_1")
            h = act(_upconv_fused(h, dec.weight.to(act_dtype), dec.bias.to(act_dtype), conv,
                                  f"dec{i+1}_1"))
            h = act(layer(f"dec{i+1}_2", h))
            if i < levels - 1:
                h = h + skips[levels - 2 - i]
        return torch.tanh(layer("final", h)).transpose(1, 2)

    return apply


def make_full_critic_apply(levels: int = 5, leaky_slope: float = 0.2,
                           act_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``apply(critic, candidate, condition)`` over a ``FullDiscriminator``'s
    parameters, with the convs on ``act_dtype`` operands; the sum over
    length and the dense layer run in float32, as in the reference."""
    _check_act_dtype(act_dtype)

    def apply(critic: nn.Module, candidate: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        h = torch.cat([candidate.to(act_dtype), condition.to(act_dtype)], dim=-1).transpose(1, 2)
        for i in range(levels):
            layer = getattr(critic, f"conv{i+1}")
            h = F.leaky_relu(_conv(f"conv{i+1}", h, layer.weight.to(act_dtype),
                                   layer.bias.to(act_dtype), stride=2), leaky_slope)
        pooled = h.sum(dim=-1, dtype=torch.float32)
        return pooled @ critic.dense.weight.float().T + critic.dense.bias.float()

    return apply
