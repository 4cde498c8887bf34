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
``x + out``, unclamped. Both compose. Either with ``act_dtype`` is not
ported and raises.
"""

from __future__ import annotations

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
                 qat: bool = False, act_dtype=None):
        super().__init__()
        if (rtl_faithful or qat) and act_dtype is not None:
            raise NotImplementedError("the qat and rtl_faithful modes with an activation storage "
                                      "format (act_dtype) are not ported (ROADMAP A.5)")
        self.leaky_slope = RTL_LEAKY_SLOPE if rtl_faithful else leaky_slope
        self.input_residual, self.rtl_faithful, self.qat = input_residual, rtl_faithful, qat
        self.act_dtype = storage_dtype(act_dtype)
        self.enc1 = _conv(input_channels, enc1_channels, 2)
        self.bottleneck = _conv(enc1_channels, bottleneck_channels, 2)
        self.dec1 = _conv(bottleneck_channels, dec1_channels, 1)
        self.out_conv = _conv(dec1_channels, output_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Noisy frames ``[B, L, 2]`` -> enhanced ``[B, L, 2]``."""
        dt = self.enc1.weight.dtype
        store = (lambda h: h) if self.act_dtype is None else (lambda h: h.to(self.act_dtype))  # noqa: E731
        block = lambda conv, h: store(F.leaky_relu(self._conv(conv, h), self.leaky_slope))  # noqa: E731
        # each stored activation is read once (torch has no fp8 addition for
        # the gradient of a second read)
        enc1 = read_stored(block(self.enc1, read_stored(x.transpose(1, 2), dt)), dt)
        bneck = read_stored(block(self.bottleneck, enc1), dt)
        dec1 = read_stored(block(self.dec1, upsample_nearest_2x(bneck)), dt)
        skip = read_stored(store(dec1 + enc1), dt)
        # the RTL's output conv: the centre tap only, the others zero
        w_out = F.pad(self.out_conv.weight[:, :, 1:2], (1, 1)) if self.rtl_faithful else None
        out = self._conv(self.out_conv, upsample_nearest_2x(skip), w_out).transpose(1, 2)
        if self.input_residual:
            return as_dtype(x, out.dtype) + out
        if self.rtl_faithful:   # the hardware's tanh: a clamp
            return torch.where(out > 1.0, RTL_TANH_CLAMP, torch.where(out < -1.0, -RTL_TANH_CLAMP,
                                                                    out))
        return torch.tanh(out)

    def _conv(self, conv: nn.Conv1d, h: torch.Tensor,
              weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``conv`` on ``h``, with ``weight`` in place of its own where given,
        under Q1.7/Q8.8 fake quantization with ``qat``."""
        w = conv.weight if weight is None else weight
        if self.qat:   # Q8.8 activations and biases, Q1.7 weights
            q88 = lambda t: fake_quantize(t, Q88_STEP, 16)  # noqa: E731
            return F.conv1d(q88(h), fake_quantize(w, Q17_STEP, 8), q88(conv.bias),
                            conv.stride, 1)
        if weight is None:
            return conv(h)
        return F.conv1d(h, w, conv.bias, conv.stride, 1)
