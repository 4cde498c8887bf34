"""Bit-true Q1.7/Q8.8 integer inference: the RTL datapath as int32 torch
ops (counterpart of ``ofdmgan_tpu/quant/intsim.py``), on the device of the
input frames.

Mode ``"rtl"`` is the hardware's arithmetic (``rtl/ofdmGAN/generator_mini.v``,
``discriminator_mini.v``):

* Q8.8 int16 activations, Q1.7 int8 weights, int32 accumulators;
* each product shifted ``>>> 7`` before it is summed (``>>`` on a signed
  tensor is arithmetic: floor division, as Verilog's ``>>>``);
* the Q8.8 bias added once per output, the sum saturated to int16;
* LeakyReLU on the saturated value: ``(x >>> 2) + (x >>> 4)`` for x < 0
  (slope 0.3125);
* the output conv's centre tap only; tanh as a clamp (above 256 -> 255,
  below -256 -> -255); the additive skip saturated to int16;
* the critic pools into int32 and its dense layer reads the pooled sums'
  low 16 bits; the score saturates to int16.

``"rtl_residual"`` replaces the clamp by a saturating add of the input,
``sat16(conv + bias + x)``. ``"float_ref"`` applies the float model's
operations quantized at each step: the requantization rounds after the
sum, ``(acc + 64) >> 7``, the slope is 0.2 rounded, the output conv has
three taps and tanh is real, evaluated as XLA evaluates float32 tanh on a
CPU, so that this mode too is bit-exact with the reference.

There is no integer matrix product on CUDA (``matmul``, ``einsum`` and
``conv1d`` raise for int32), so a conv is a sum over its taps of broadcast
products, over frames in chunks of ``CHUNK``. ``torch.sum`` of int32
returns int64: sums are cast back to int32 (they cannot overflow here).
Weights come from ``quantize_weights_rtl``: round(w * 128), round(b * 256).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .export import discriminator_layers, generator_layers

I16_MAX, I16_MIN = 32767, -32768
CHUNK = 1 << 16   # frames per pass: bounds the broadcast products' memory

# XLA's float32 tanh on a CPU: Eigen's rational approximation with float32
# coefficients, evaluated with fused multiply-adds, the input clamped to
# +-TANH_CLAMP
TANH_CLAMP = 7.99881172180175781
TANH_NUM = tuple(float(np.float32(c)) for c in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04, 4.89352455891786e-03))
TANH_DEN = tuple(float(np.float32(c)) for c in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03, 4.89352518554385e-03))


class IntLayer(NamedTuple):
    weight: np.ndarray  # int [out, in, k] (Q1.7), or [out, in] for the dense layer
    bias: np.ndarray    # int [out] (Q8.8)


class IntGenParams(NamedTuple):
    enc1: IntLayer
    bottleneck: IntLayer
    dec1: IntLayer
    out_conv: IntLayer  # the rtl modes use its centre tap only


class IntDiscParams(NamedTuple):
    conv1: IntLayer
    conv2: IntLayer
    dense: IntLayer


def _sat16(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, I16_MIN, I16_MAX)


def _int32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=like.device)


def quantize_weights_rtl(params, model: str = "generator"):
    """A model of the port or a flax-layout tree -> true Q1.7 weights and
    Q8.8 biases (numpy int32): what the RTL ROM holds, not the per-channel
    scaled int8 of the export."""
    layers = generator_layers(params) if model == "generator" else discriminator_layers(params)

    def q(layer):
        w = np.clip(np.round(layer.weight * 128.0), -128, 127).astype(np.int32)
        b = np.clip(np.round(layer.bias * 256.0), I16_MIN, I16_MAX).astype(np.int32)
        return IntLayer(w, b)

    if model == "generator":
        return IntGenParams(*(q(layer) for layer in layers))
    return IntDiscParams(*(q(layer) for layer in layers))


def float_to_q88(x: torch.Tensor) -> torch.Tensor:
    """Float -> Q8.8 int32, truncated toward zero (the golden-vector and
    testbench convention), saturated to int16."""
    return _sat16(torch.trunc(x * 256.0)).to(torch.int32)


def q88_to_float(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) / 256.0


def _fma(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """float32 a * b + c with one rounding: the float32 product is exact in
    float64."""
    return (a.double() * b.double() + c).float()


def _tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 tanh as XLA computes it on a CPU (bit for bit on every Q8.8
    value: ``tests/test_torch_quant.py``)."""
    xc = torch.clamp(x, -TANH_CLAMP, TANH_CLAMP)
    x2 = xc * xc
    num = torch.full_like(x2, TANH_NUM[0])
    for c in TANH_NUM[1:]:
        num = _fma(x2, num, c)
    den = torch.full_like(x2, TANH_DEN[0])
    for c in TANH_DEN[1:]:
        den = _fma(x2, den, c)
    return torch.where(x.abs() < 0.0004, x, (xc * num) / den)


def _conv1d_int(x: torch.Tensor, layer: IntLayer, stride: int, mode: str) -> torch.Tensor:
    """Strided k = 3, padding 1 integer conv of int32 Q8.8 ``[B, L, C_in]``,
    requantized per product (``rtl``) or after the sum (``float_ref``);
    returns the unsaturated int32 pre-activation ``[B, L_out, C_out]``."""
    w = _int32(layer.weight, x).permute(2, 1, 0)   # [k, in, out]
    b = _int32(layer.bias, x)
    k = w.shape[0]
    l_out = (x.shape[1] + 2 - k) // stride + 1
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1))
    acc = torch.zeros((x.shape[0], l_out, w.shape[2]), dtype=torch.int64, device=x.device)
    for tap in range(k):
        win = xp[:, tap:tap + stride * (l_out - 1) + 1:stride, :]   # [B, L_out, in]
        prod = win[..., None] * w[tap]                               # [B, L_out, in, out]
        acc += (prod >> 7 if mode == "rtl" else prod).sum(dim=2)
    acc = acc.to(torch.int32)
    if mode != "rtl":
        acc = (acc + 64) >> 7   # round-to-nearest requantization
    return acc + b


def _lrelu_int(x: torch.Tensor, mode: str) -> torch.Tensor:
    """``x`` saturated to int16. rtl: (x >>> 2) + (x >>> 4) below zero;
    float_ref: 0.2 * x rounded, as 51/256."""
    if mode == "rtl":
        neg = (x >> 2) + (x >> 4)
    else:
        neg = torch.sign(x) * ((x.abs() * 51 + 128) >> 8)
    return torch.where(x < 0, neg, x)


def _upsample2_int(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=-2)


def _chunked(fn, *frames: torch.Tensor) -> torch.Tensor:
    n = frames[0].shape[0]
    if n <= CHUNK:
        return fn(*frames)
    return torch.cat([fn(*(f[i:i + CHUNK] for f in frames)) for i in range(0, n, CHUNK)])


def generator_int_forward(iparams: IntGenParams, x_q88: torch.Tensor,
                          mode: str = "rtl") -> torch.Tensor:
    """Integer mini U-Net: int Q8.8 ``[B, L, 2]`` -> int32 Q8.8 ``[B, L, 2]``,
    in ``generator_mini.v``'s order ENC1 -> BNECK -> UPSAMPLE1 -> DEC1 ->
    SKIP_ADD -> UPSAMPLE2 -> OUT_CONV -> TANH; ``mode`` is ``"rtl"``,
    ``"rtl_residual"`` or ``"float_ref"``."""
    if mode not in ("rtl", "rtl_residual", "float_ref"):
        raise ValueError(f"unknown mode {mode!r}")
    return _chunked(lambda x: _generator(iparams, x, mode), x_q88.to(torch.int32))


def _generator(iparams: IntGenParams, x: torch.Tensor, mode: str) -> torch.Tensor:
    residual = mode == "rtl_residual"
    if residual:
        mode = "rtl"
    enc1 = _lrelu_int(_sat16(_conv1d_int(x, iparams.enc1, 2, mode)), mode)
    bneck = _lrelu_int(_sat16(_conv1d_int(enc1, iparams.bottleneck, 2, mode)), mode)
    dec1 = _lrelu_int(_sat16(_conv1d_int(_upsample2_int(bneck), iparams.dec1, 1, mode)), mode)
    up2 = _upsample2_int(_sat16(dec1 + enc1))
    if mode != "rtl":
        out = _sat16(_conv1d_int(up2, iparams.out_conv, 1, mode))
        return float_to_q88(_tanh_f32(q88_to_float(out)))
    w = _int32(iparams.out_conv.weight, x)
    w_center = w[:, :, w.shape[2] // 2] if w.dim() == 3 else w   # [out, in]
    prod = up2[..., None] * w_center.T
    acc = (prod >> 7).sum(dim=2).to(torch.int32) + _int32(iparams.out_conv.bias, x)
    if residual:   # a saturating input add in place of the clamp
        return _sat16(acc + x)
    out = _sat16(acc)
    # tanh as a clamp (generator_mini.v:630-648): above 256 -> 255, below -256 -> -255
    out = torch.where(out > 256, 255, out)
    return torch.where(out < -256, -255, out)


def discriminator_int_forward(iparams: IntDiscParams, cand_q88: torch.Tensor,
                              cond_q88: torch.Tensor, mode: str = "rtl") -> torch.Tensor:
    """Integer critic: int Q8.8 ``[B, L, 2]`` x 2 -> int32 Q8.8 score
    ``[B, 1]``, in ``discriminator_mini.v``'s order CONV1 -> CONV2 -> POOL ->
    DENSE -> saturate."""
    if mode not in ("rtl", "float_ref"):
        raise ValueError(f"unknown mode {mode!r}")
    return _chunked(lambda a, b: _discriminator(iparams, a, b, mode),
                    cand_q88.to(torch.int32), cond_q88.to(torch.int32))


def _discriminator(iparams: IntDiscParams, cand: torch.Tensor, cond: torch.Tensor,
                   mode: str) -> torch.Tensor:
    x = torch.cat([cand, cond], dim=-1)
    h = _lrelu_int(_sat16(_conv1d_int(x, iparams.conv1, 2, mode)), mode)
    h = _lrelu_int(_sat16(_conv1d_int(h, iparams.conv2, 2, mode)), mode)
    pool = h.sum(dim=-2).to(torch.int32)   # [B, C]
    if mode == "rtl":
        # the dense layer reads the pooled sums' low 16 bits (discriminator_mini.v:454)
        pool16 = ((pool + 32768) & 0xFFFF) - 32768
    else:
        pool16 = _sat16(pool)
    prod = pool16[:, None, :] * _int32(iparams.dense.weight, pool)[None]   # [B, 1, C]
    b = _int32(iparams.dense.bias, pool)
    if mode == "rtl":
        acc = (prod >> 7).sum(dim=-1).to(torch.int32) + b
    else:
        acc = ((prod.sum(dim=-1).to(torch.int32) + 64) >> 7) + b
    return _sat16(acc)


def quantization_error_report(params, x_float: torch.Tensor, mode: str = "rtl") -> dict:
    """The integer datapath against the float mini generator on a batch of
    frames ``[B, L, 2]`` (reference ``intsim.py:230-247``): the MSE and the
    largest error in float units, and the float output's RMS. ``params``: a
    ``MiniGenerator`` of the port or a flax-layout tree; the float forward is
    the default generator's (tanh head) with those parameters."""
    from ..models import MiniGenerator
    from ..utils.jax_params import from_jax_params

    gen = MiniGenerator().to(x_float.device)
    gen.load_state_dict(params.state_dict() if isinstance(params, torch.nn.Module)
                        else from_jax_params(params))
    with torch.no_grad():
        y_float = gen(x_float)
    ip = quantize_weights_rtl(params, "generator")
    y_int = q88_to_float(generator_int_forward(ip, float_to_q88(x_float), mode))
    err = y_int - y_float
    return {"mse": float((err ** 2).mean()), "max_abs": float(err.abs().max()),
            "rms_float": float((y_float ** 2).mean().sqrt())}
