"""Flat-layout ``[B, F]`` applies of the mini generator and critic.

Counterpart of ``ofdmgan_tpu/models/flat.py``. Each mini layer is one
dense matmul on the flattened frame (``ops/dense_conv.py``, index
``t*C + c``); these applies compute ``MiniGenerator``'s and
``MiniDiscriminator``'s functions from their parameters (the torch layout
``[C_out, C_in, K]``, so checkpoints stay as they are) with activations
kept ``[B, F]``:

* each nearest-neighbour upsample is a fixed 0/1 map ``U``, folded into the
  next layer's dense matrix (``U @ A``, a product of parameters);
* the critic's concat of candidate and condition is two matmuls against
  the dense matrices of conv1's kernel-channel slices (``w[:, :2]``,
  ``w[:, 2:]``), so the penalty's gradient with respect to the candidate
  flows through one of them;
* the sum pool and the dense layer fold into one ``[F, 1]`` vector.

``make_*_flat_parts`` return ``(premap, apply_mats)``: ``premap(module)``
builds the dense matrices once, ``apply_mats(mats, ...)`` applies them
(the training step's ``premap``: the matrices built once per parameter
value per loss, shared by every apply of that loss). ``make_*_flat_apply``
return ``apply(module, ...)``, which builds them at each call.
``act_dtype`` stores each activation in that format, as the reference
does; ``input_residual`` is the residual head. ``mm`` picks the batch-side
products: ``"ambient"``, a matmul under the step's numerics mode (the
product of a bf16 activation and float32 weights summed in float32; fp8 is
read through bf16), or ``"tf32x3"``, ``tf32_matmul``. The dense matrices
are ``ops/dense_conv.py``'s, in the reference's ``"onehot"`` form; its
``"dus"`` form gives the same matrices bit for bit and is not ported (the
trainer accepts ``conv_expand`` and changes nothing).

What is ported, and why: on a TPU the flat layout avoids relayout passes
between layers; on a GPU it has no such role (``PERF.md``), but the flat
step is the layout the reference's headline recipe trains in
(``bench.py --flat --premap --mm tf32x3_gp``), and ``tf32_matmul`` is the
numerics of its gradient-penalty chain, which no other mode of the port
computes. Under ``bfloat16`` the flat critic rounds each layer-2
activation before the pooled product, where the module rounds the pooled
sum: the two differ within bf16 rounding, as the reference's do.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import bf16_dots
from ..ops.dense_conv import conv1d_dense_matrix
from .generator import FP8_DTYPES, as_dtype, storage_dtype

MM_MODES = ("ambient", "tf32x3")


@functools.lru_cache(maxsize=None)
def _upsample_matrix(l_in: int, c: int, device: torch.device) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of ``[l_in, c]`` frames as a
    ``[l_in*c, 2*l_in*c]`` 0/1 map; kept per device."""
    u = np.zeros((l_in * c, 2 * l_in * c), np.float32)
    for t in range(l_in):
        for ch in range(c):
            u[t * c + ch, (2 * t) * c + ch] = 1.0
            u[t * c + ch, (2 * t + 1) * c + ch] = 1.0
    return torch.from_numpy(u).to(device)


def _read(h: torch.Tensor) -> torch.Tensor:
    """A stored activation as a matmul reads it: fp8 through bf16 (exact)."""
    return h.to(torch.bfloat16) if h.dtype in FP8_DTYPES else h


def _mm(h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``h @ a`` in the promoted dtype: a bf16 activation against float32
    weights sums float32 products (the upcast is exact)."""
    h = _read(h)
    return torch.matmul(as_dtype(h, torch.promote_types(h.dtype, a.dtype)), a)


def _split(t: torch.Tensor):
    """bf16 high and low parts of ``t``; bf16 or fp8 storage has no low part."""
    if t.dtype == torch.bfloat16 or t.dtype in FP8_DTYPES:
        return t.to(torch.bfloat16), None
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def _dot(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """One pass of bf16 operands summed in float32, in every derivative too:
    the TPU's dot at ``Precision.DEFAULT`` (``ops/bf16_dots.matmul``)."""
    return bf16_dots.matmul(p.float(), q.float())


def tf32_matmul(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``x @ a`` as the reference's bf16x3 decomposition
    (``ofdmgan_tpu/models/flat.py:83-125``): ``xh@ah + xh@al + xl@ah`` on the
    bf16 high and low parts of each float32 operand, each product exact in
    float32, only the sums rounding. It does not depend on the step's
    numerics mode: the parts are bf16 values, so a bf16 mode rounds nothing
    more and TF32 leaves the products exact.

    Its derivatives are those the reference computes. JAX differentiates a
    ``custom_jvp`` function in reverse mode by transposing its body, so the
    reference's gradients are the transposes of the decomposition: each
    cotangent meets a one-pass bf16 dot and is rounded to bf16 where it
    reaches a bf16 part (measured against float64: its first derivatives
    lie as far from exact as one-pass bf16's, ``tests/test_torch_flat.py``).
    Autograd of this composition computes the same transposes, in every
    order (the penalty's double backward)."""
    xh, xl = _split(x)
    ah, al = _split(a)
    y = _dot(xh, ah)
    if al is not None:
        y = y + _dot(xh, al)
    if xl is not None:
        y = y + _dot(xl, ah)
    return y


def _dots(mm: str) -> Callable:
    if mm not in MM_MODES:
        raise ValueError(f"mm must be one of {MM_MODES}, not {mm!r}")
    return _mm if mm == "ambient" else tf32_matmul


def _caster(act_dtype) -> Callable:
    dtype = storage_dtype(act_dtype)
    return (lambda h: h) if dtype is None else (lambda h: h.to(dtype))


def make_generator_flat_parts(frame_length: int = 16, input_channels: int = 2,
                              output_channels: int = 2, enc1_channels: int = 4,
                              bottleneck_channels: int = 8, dec1_channels: int = 4,
                              leaky_slope: float = 0.2, act_dtype=None,
                              input_residual: bool = False, mm: str = "ambient"):
    """``(premap, apply_mats)`` of ``MiniGenerator``: ``premap(generator)``
    builds its eight dense matrices and tiled biases, ``apply_mats(mats, x)``
    maps noisy frames ``[B, L, 2]`` or ``[B, 2L]`` to enhanced ones of the
    same shape."""
    L = frame_length
    cast, dot = _caster(act_dtype), _dots(mm)

    def premap(g):
        dev = g.enc1.weight.device
        u1 = _upsample_matrix(L // 4, bottleneck_channels, dev)
        u2 = _upsample_matrix(L // 2, dec1_channels, dev)
        dense = conv1d_dense_matrix
        return (dense(g.enc1.weight, L, 2, 1), g.enc1.bias.repeat(L // 2),
                dense(g.bottleneck.weight, L // 2, 2, 1), g.bottleneck.bias.repeat(L // 4),
                u1 @ dense(g.dec1.weight, L // 2, 1, 1), g.dec1.bias.repeat(L // 2),
                u2 @ dense(g.out_conv.weight, L, 1, 1), g.out_conv.bias.repeat(L))

    def apply_mats(mats, x):
        a_e, b_e, a_b, b_b, a_d, b_d, a_o, b_o = mats
        xf = x.reshape(x.shape[0], L * input_channels)
        h1 = cast(F.leaky_relu(dot(xf, a_e) + b_e, leaky_slope))
        if h1.dtype in FP8_DTYPES:   # read once: torch adds no fp8 gradients
            h1 = h1.to(torch.bfloat16)
        h2 = cast(F.leaky_relu(dot(h1, a_b) + b_b, leaky_slope))
        h3 = cast(F.leaky_relu(dot(h2, a_d) + b_d, leaky_slope))
        h4 = cast(_read(h3) + h1)   # the additive skip (generator.py:171)
        out = dot(h4, a_o) + b_o
        y = as_dtype(xf, out.dtype) + out if input_residual else torch.tanh(out)
        return y.reshape(x.shape[0], L, output_channels) if x.dim() == 3 else y

    return premap, apply_mats


def make_generator_flat_apply(*args, **kwargs) -> Callable:
    """``apply(generator, x)``: ``make_generator_flat_parts``'s apply on the
    matrices built at the call."""
    premap, apply_mats = make_generator_flat_parts(*args, **kwargs)
    return lambda g, x: apply_mats(premap(g), x)


def make_critic_flat_parts(frame_length: int = 16, conv1_channels: int = 8,
                           conv2_channels: int = 16, leaky_slope: float = 0.2,
                           act_dtype=None, mm: str = "ambient"):
    """``(premap, apply_mats)`` of ``MiniDiscriminator``:
    ``apply_mats(mats, candidate, condition)`` is the ``[B, 1]`` score."""
    L = frame_length
    cast, dot = _caster(act_dtype), _dots(mm)

    def premap(c):
        dense = conv1d_dense_matrix
        w1 = c.conv1.weight   # input channels 0-1 the candidate, 2-3 the condition
        return (dense(w1[:, :2], L, 2, 1), dense(w1[:, 2:], L, 2, 1), c.conv1.bias.repeat(L // 2),
                dense(c.conv2.weight, L // 2, 2, 1), c.conv2.bias.repeat(L // 4),
                c.dense.weight[0].repeat(L // 4)[:, None], c.dense.bias)

    def apply_mats(mats, candidate, condition):
        a1c, a1d, b1, a2, b2, q, bias = mats
        b = candidate.shape[0]
        z1 = dot(candidate.reshape(b, L * 2), a1c) + dot(condition.reshape(b, L * 2), a1d) + b1
        h1 = cast(F.leaky_relu(z1, leaky_slope))
        h2 = F.leaky_relu(dot(h1, a2) + b2, leaky_slope)
        return dot(h2, q) + bias   # the float32 sum pool and the dense layer

    return premap, apply_mats


def make_critic_flat_apply(*args, **kwargs) -> Callable:
    """``apply(critic, candidate, condition)``: ``make_critic_flat_parts``'s
    apply on the matrices built at the call."""
    premap, apply_mats = make_critic_flat_parts(*args, **kwargs)
    return lambda c, cand, cond: apply_mats(premap(c), cand, cond)


STEP_MM_MODES = ("ambient", "tf32x3", "tf32x3_gp")


@dataclasses.dataclass(frozen=True)
class FlatStep:
    """The flat applies a ``TrainStep`` trains through. Each apply takes the
    module, or with ``*_premap`` the matrices ``premap(module)`` built once
    per loss; ``critic_apply_gp`` (or ``None``: ``critic_apply``) is the
    critic of the gradient-penalty chain. ``module_critic``: the critic
    applies compute the module's function (``mm`` ambient, no storage
    format), the one the critic kernel computes."""

    gen_apply: Callable
    critic_apply: Callable
    critic_apply_gp: Optional[Callable]
    gen_premap: Optional[Callable]
    critic_premap: Optional[Callable]
    module_critic: bool


def make_flat_step(generator, critic, frame_length: int, act_dtype=None, mm: str = "ambient",
                   premap: bool = False) -> FlatStep:
    """The flat step of the mini pair (reference ``trainer.py:193-252``):
    ``mm="tf32x3_gp"`` keeps the model's products ambient and puts the
    penalty chain's on ``tf32_matmul``."""
    if mm not in STEP_MM_MODES:
        raise ValueError(f"mm must be one of {STEP_MM_MODES}, not {mm!r}")
    mm_model = "ambient" if mm == "tf32x3_gp" else mm
    g_kw = dict(frame_length=frame_length, input_channels=generator.enc1.in_channels,
                output_channels=generator.out_conv.out_channels,
                enc1_channels=generator.enc1.out_channels,
                bottleneck_channels=generator.bottleneck.out_channels,
                dec1_channels=generator.dec1.out_channels, leaky_slope=generator.leaky_slope,
                act_dtype=act_dtype, input_residual=generator.input_residual)
    c_kw = dict(frame_length=frame_length, conv1_channels=critic.conv1.out_channels,
                conv2_channels=critic.conv2.out_channels, leaky_slope=critic.leaky_slope,
                act_dtype=act_dtype)
    g_pre, g_apply = make_generator_flat_parts(mm=mm_model, **g_kw)
    c_pre, c_apply = make_critic_flat_parts(mm=mm_model, **c_kw)
    c_gp = make_critic_flat_parts(mm="tf32x3", **c_kw)[1] if mm == "tf32x3_gp" else None
    module_critic = mm == "ambient" and act_dtype is None
    if premap:
        return FlatStep(g_apply, c_apply, c_gp, g_pre, c_pre, module_critic)
    # the matrices built at every apply
    return FlatStep(lambda g, x: g_apply(g_pre(g), x),
                    lambda c, *a: c_apply(c_pre(c), *a),
                    None if c_gp is None else (lambda c, *a: c_gp(c_pre(c), *a)),
                    None, None, module_critic)
