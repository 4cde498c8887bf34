"""Mini 1-D U-Net generator (counterpart of
``ofdmgan_tpu/models/generator.py:123-199``).

    [B, L, 2] -> enc1 (2->4, k3, s2) -> bottleneck (4->8, k3, s2)
    -> upsample x2 -> dec1 (8->4, k3, s1) -> + enc1
    -> upsample x2 -> out_conv (4->2, k3, s1) -> tanh | + input

LeakyReLU(0.2) after every conv but the last, Xavier-uniform weights, zero
biases, 258 parameters. ``input_residual`` selects the residual head
``y = x + out_conv(...)`` in place of ``tanh``. ``act_dtype`` (bfloat16,
float8_e4m3fn or float8_e5m2) stores each activation in that format, as
the reference's ``act_dtype`` does (``generator.py:63-64``): every conv
reads its input upcast to float32 (exact) against float32 weights, and fp8
is read as the reference reads it through bf16 (``ops/dense_conv.py:174-178``,
also exact).

``qat`` trains under Q1.7/Q8.8 fake quantization (``generator.py:67-113``):
each conv reads its input rounded to 1/256 (Q8.8), its weights to 1/128
(Q1.7, clamped to [-1, 127/128]) and its bias to 1/256, with identity
gradients. ``rtl_faithful`` trains the RTL's own operations
(``generator.py:162-192``): LeakyReLU slope 0.3125, an output conv masked
to its centre tap (the masked taps stay parameters: 258 in all) and
tanh as a clamp to +-255/256; with ``input_residual`` the output is
``x + out``, unclamped. Both compose, and both compose with ``act_dtype``.
There the reference's Q8.8 rounding (``q88_ste``: ``round(x*256)``, the
clip to the int16 range, ``/256`` and ``x + sg(q - x)``) acts on the
stored value in its storage format, and every one of those operations
rounds to that format (``q88_stored``): the clip's bounds too, so in
``float8_e4m3fn``, which holds neither -32768 nor 32767, the bounds are NaN
and every output of a ``qat`` forward is NaN, as in the reference (XLA
converts a value past e4m3fn's range to NaN where torch saturates it to
+-448; ``round_stored`` converts as XLA does). ``rtl_faithful`` without
``qat`` rounds nothing more and is finite in every format.

A ``conv_fn(name, h, weight, bias, stride, (left, right) padding)`` given to
``forward`` computes each convolution in place of ``F.conv1d`` (the
sequence-parallel convolutions of ``parallel/gspmd.py``); the weights and
bias it gets are those the layer applies (fake-quantized under ``qat``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dense_conv import upsample_nearest_2x
from ..quant.fakequant import fake_quantize

FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
ACT_DTYPES = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def storage_dtype(act_dtype) -> Optional[torch.dtype]:
    """``None``, a name of ``ACT_DTYPES`` or a torch dtype -> a torch dtype or ``None``."""
    if act_dtype is None or isinstance(act_dtype, torch.dtype):
        return act_dtype
    if act_dtype not in ACT_DTYPES:
        raise ValueError(f"act_dtype must be one of {ACT_DTYPES}, not {act_dtype!r}")
    return getattr(torch, act_dtype)


def as_dtype(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``h`` in ``dtype``, without a dispatched call where it already is (the
    mini step is bound by its host's calls)."""
    return h if h.dtype == dtype else h.to(dtype)


def read_stored(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A stored activation read as ``dtype`` for a conv; fp8 goes through
    bf16 as in the reference, so a gradient flowing back is rounded to bf16
    before fp8, as there."""
    return as_dtype(h.to(torch.bfloat16) if h.dtype in FP8_DTYPES else h, dtype)


Q17_STEP, Q88_STEP = 2.0 ** -7, 2.0 ** -8
RTL_LEAKY_SLOPE = 0.3125   # the RTL's (x >>> 2) + (x >>> 4)
RTL_TANH_CLAMP = 255.0 / 256.0
# float8_e4m3fn's largest value is 448 and the next step would be 480: XLA
# rounds to nearest even up to their midpoint and gives NaN past it
E4M3_NAN_ABOVE = 464.0


def round_stored(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the storage format ``dtype`` as XLA converts it, as
    float32: round to nearest even, inf past the range of a format that has
    one (bf16, e5m2), NaN past e4m3fn's (torch's own cast saturates it)."""
    r = t.to(dtype).float()
    if dtype == torch.float8_e4m3fn:
        r = torch.where(t.abs() > E4M3_NAN_ABOVE, float("nan"), r)
    return r


def q88_stored(h: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The reference's ``q88_ste`` (``generator.py:68-71``) on ``h``, float32
    holding values of the storage format ``dtype`` (``None``: float32):
    forward, each of its operations rounded to ``dtype``; backward, the
    identity."""
    if dtype is None:
        return fake_quantize(h, Q88_STEP, 16)
    with torch.no_grad():
        rnd = functools.partial(round_stored, dtype=dtype)
        # filled on the device (a graphed step copies nothing from the host)
        lo, hi = rnd(h.new_full((), -32768.0)), rnd(h.new_full((), 32767.0))
        r = torch.round(rnd(h * 256.0))
        # max/min propagate a NaN bound, as XLA's clip does
        q = rnd(torch.minimum(torch.maximum(r, lo), hi) / 256.0)
        y = rnd(h + rnd(q - h))
    return h + (y - h).detach()


def _conv(cin: int, cout: int, stride: int) -> nn.Conv1d:
    conv = nn.Conv1d(cin, cout, 3, stride=stride, padding=1)
    nn.init.xavier_uniform_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


def conv1d_padded(h: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int,
                  pads) -> torch.Tensor:
    """``F.conv1d`` with (left, right) zero padding."""
    if pads[0] == pads[1]:
        return F.conv1d(h, w, b, stride, pads[0])
    return F.conv1d(F.pad(h, pads), w, b, stride)


def apply_conv(conv: nn.Conv1d, name: str, h: torch.Tensor, conv_fn=None,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Layer ``name``'s convolution on ``h``, with ``weight``/``bias`` in
    place of its own where given, through ``conv_fn`` where given."""
    if conv_fn is None and weight is None and bias is None:
        return conv(h)
    w = conv.weight if weight is None else weight
    b = conv.bias if bias is None else bias
    p = conv.padding[0]
    if conv_fn is not None:
        return conv_fn(name, h, w, b, conv.stride[0], (p, p))
    return F.conv1d(h, w, b, conv.stride, p)


def count_parameters(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


class MiniGenerator(nn.Module):
    def __init__(self, input_channels: int = 2, output_channels: int = 2,
                 enc1_channels: int = 4, bottleneck_channels: int = 8,
                 dec1_channels: int = 4, leaky_slope: float = 0.2,
                 input_residual: bool = False, rtl_faithful: bool = False,
                 qat: bool = False, act_dtype=None):
        super().__init__()
        self.leaky_slope = RTL_LEAKY_SLOPE if rtl_faithful else leaky_slope
        self.input_residual, self.rtl_faithful, self.qat = input_residual, rtl_faithful, qat
        self.act_dtype = storage_dtype(act_dtype)
        self.enc1 = _conv(input_channels, enc1_channels, 2)
        self.bottleneck = _conv(enc1_channels, bottleneck_channels, 2)
        self.dec1 = _conv(bottleneck_channels, dec1_channels, 1)
        self.out_conv = _conv(dec1_channels, output_channels, 1)

    def forward(self, x: torch.Tensor, conv_fn=None) -> torch.Tensor:
        """Noisy frames ``[B, L, 2]`` -> enhanced ``[B, L, 2]``."""
        dt, act = self.enc1.weight.dtype, self.act_dtype
        store = (lambda h: h) if act is None else (lambda h: h.to(act))  # noqa: E731

        def block(name, h, fmt):
            # each stored activation is read once (torch has no fp8 addition
            # for the gradient of a second read)
            y = F.leaky_relu(self._conv(name, h, fmt, conv_fn), self.leaky_slope)
            return read_stored(store(y), dt)

        x_fmt = x.dtype if x.dtype != dt else None   # the batch's storage format
        enc1 = block("enc1", read_stored(x.transpose(1, 2), dt), x_fmt)
        bneck = block("bottleneck", enc1, act)
        dec1 = block("dec1", upsample_nearest_2x(bneck), act)
        skip = read_stored(store(dec1 + enc1), dt)
        # the RTL's output conv: the centre tap only, the others zero (a
        # mask, as the reference's, so a NaN gradient reaches every tap)
        w = self.out_conv.weight
        w_out = w * F.pad(torch.ones_like(w[:, :, 1:2]), (1, 1)) if self.rtl_faithful else None
        out = self._conv("out_conv", upsample_nearest_2x(skip), act, conv_fn,
                         w_out).transpose(1, 2)
        if self.input_residual:
            return as_dtype(x, out.dtype) + out
        if self.rtl_faithful:   # the hardware's tanh: a clamp
            return torch.where(out > 1.0, RTL_TANH_CLAMP, torch.where(out < -1.0, -RTL_TANH_CLAMP,
                                                                    out))
        return torch.tanh(out)

    def _conv(self, name: str, h: torch.Tensor, fmt: Optional[torch.dtype], conv_fn=None,
              weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Layer ``name`` on ``h`` (holding values of the storage format
        ``fmt``, ``None``: float32), with ``weight`` in place of its own
        where given, under Q1.7/Q8.8 fake quantization with ``qat``."""
        conv = getattr(self, name)
        if not self.qat:
            return apply_conv(conv, name, h, conv_fn, weight)
        w = conv.weight if weight is None else weight
        return apply_conv(conv, name, q88_stored(h, fmt), conv_fn,
                          fake_quantize(w, Q17_STEP, 8), fake_quantize(conv.bias, Q88_STEP, 16))
