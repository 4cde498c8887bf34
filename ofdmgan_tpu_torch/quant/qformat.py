"""Fixed-point Q-formats and symmetric-scale quantization (counterpart of
``ofdmgan_tpu/quant/qformat.py``).

* scale = max(max|x|, 1e-8) / (2^(n-1) - 1); quantize = round, then clamp;
* Q1.7 weights (x * 2^7, int8), Q8.8 activations (x * 2^8, int16), Q16.16
  accumulators (int32);
* the golden-vector encoding truncates value * 256 toward zero.

``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

Q17_FRAC = 7     # weights: 1 sign + 7 fraction bits (int8)
Q88_FRAC = 8     # activations: 8 integer + 8 fraction bits (int16)
Q1616_FRAC = 16  # accumulators (int32)


def compute_scale(x: torch.Tensor, n_bits: int, per_channel: bool = False,
                  channel_axis: int = 0) -> torch.Tensor:
    """Symmetric quantization scale, per tensor or per ``channel_axis``
    (kept as a size-1 axis elsewhere)."""
    max_q = 2 ** (n_bits - 1) - 1
    if per_channel:
        # as in the reference, a negative channel_axis keeps no axis
        axes = tuple(i for i in range(x.dim()) if i != channel_axis)
        abs_max = x.abs().amax(dim=axes, keepdim=True)
    else:
        abs_max = x.abs().max()
    return torch.clamp(abs_max, min=1e-8) / max_q


def quantize(x: torch.Tensor, scale, n_bits: int) -> torch.Tensor:
    """round(x / scale) clamped to the signed n-bit range, in ``x``'s
    floating dtype."""
    hi = 2 ** (n_bits - 1) - 1
    return torch.clamp(torch.round(x / scale), -hi - 1, hi)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q * scale


def float_to_fixed(x: torch.Tensor, frac_bits: int, width: int,
                   rounding: str = "round") -> torch.Tensor:
    """Float -> signed fixed-point int32, saturated to ``width`` bits;
    ``rounding`` is ``"round"`` (the export path) or ``"trunc"`` (toward
    zero: the golden-vector convention)."""
    scaled = x * (2 ** frac_bits)
    if rounding == "trunc":
        q = torch.trunc(scaled)
    elif rounding == "round":
        q = torch.round(scaled)
    else:
        raise ValueError(rounding)
    hi = 2 ** (width - 1) - 1
    # clamped in float64, where 2^31 - 1 is exact: a float32 clamp would
    # give 2^31, which int32 cannot hold (XLA's conversion saturates it)
    return torch.clamp(q.double(), -hi - 1, hi).to(torch.int32)


def fixed_to_float(q: torch.Tensor, frac_bits: int) -> torch.Tensor:
    return q.to(torch.float32) / (2 ** frac_bits)


def to_hex16(v: int) -> str:
    """16-bit two's-complement uppercase hex (the golden-vector files)."""
    return f"{int(v) & 0xFFFF:04X}"


def to_hex8(v: int) -> str:
    return f"{int(v) & 0xFF:02X}"
