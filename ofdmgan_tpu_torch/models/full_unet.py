"""The full-scale U-Net family: the 1024-sample, 5-level generator and its
critic (counterpart of ``ofdmgan_tpu/models/full_unet.py:77-182``).

    enc_i:   conv(s2) + conv(s1)       L: 1024 -> 512 -> 256 -> 128 -> 64 -> 32
    bottle:  conv(s1) x2 at 512 channels
    dec_i:   upsample x2 + conv(s1) x2, then + the encoder's skip (i < levels)
    final:   conv(32 -> 2, k3) + tanh

Channels 2 -> 32 -> 64 -> 128 -> 256 -> 512 at the default width; every conv
is k = 3 with padding (1, 1), followed by LeakyReLU(0.2) except the last;
additive skips at every decoder level but the last (no skip at input
resolution). Submodule names are the reference's layer names
(``full_unet_layer_names``), so the JAX weight bridge maps them one to one.
3,936,578 generator and 524,129 critic parameters at levels 5, base 32.

Both models take and return channels-last ``[B, L, 2]`` and run
channels-first inside: each transposes once at its boundary. ``encode`` and
``decode`` are separate so that the two stages of the pipeline
(``parallel/pipeline.py``) apply them apart. A ``conv_fn(name, h, weight,
bias, stride, (left, right) padding)`` given to either model's forward
computes each convolution in place of ``F.conv1d`` (the tensor- and
sequence-parallel convolutions of ``parallel/gspmd.py``; the weight it gets
is the fake-quantized one under ``weight_bits``), and the critic's ``pool``
takes its sum over length further (across the processes that hold the
frame's other pieces).
``unet_param_shardings`` and ``unet_param_shardings_rowparallel`` are the
reference's tensor-parallel rules (``full_unet.py:185-251``).

``weight_bits``/``act_bits`` > 0 simulate the int8 export's quantization
(``full_unet.py:53-156``), and train under it through the straight-through
estimator: every conv kernel fake-quantized per output channel to
``weight_bits``, every stored activation (the input, each LeakyReLU output,
each skip sum) fake-quantized per tensor to ``act_bits`` by its own max.
The parameters are the float model's, under the same names, so any
checkpoint runs under either forward. ``amax(local_max, name)`` given to
the generator's forward turns each of those maxima into the global one
where a process holds a shard of the tensor (``parallel/gspmd.py``): it
gets the largest magnitude of ``"<layer>.weight"``'s shard per output
channel, of the input (``"input"``), of a layer's LeakyReLU output (the
layer's name) and of a skip sum (``"skip"``).

Inputs in a storage format (bf16, fp8) are read upcast to the weights'
float32, as flax's promotion reads them in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dense_conv import upsample_nearest_2x
from ..quant.fakequant import fake_quantize, fake_quantize_auto
from .generator import _conv, apply_conv, as_dtype


def full_unet_layer_names(levels: int = 5) -> List[str]:
    """The generator's layers in the reference export's order
    (``full_unet.py:254-263``)."""
    names = []
    for i in range(levels):
        names += [f"enc{i+1}_1", f"enc{i+1}_2"]
    names += ["bottle1", "bottle2"]
    for i in range(levels):
        names += [f"dec{i+1}_1", f"dec{i+1}_2"]
    return names + ["final"]


def check_frame_length(length: int, levels: int) -> None:
    if length % (2 ** levels):
        raise ValueError(f"frame length {length} is not divisible by 2^levels = {2 ** levels}")


class FullUNetGenerator(nn.Module):
    """``[B, L, 2] -> [B, L, 2]``; L divisible by 2^levels."""

    def __init__(self, frame_length: int = 1024, levels: int = 5, base_channels: int = 32,
                 output_channels: int = 2, leaky_slope: float = 0.2,
                 weight_bits: int = 0, act_bits: int = 0):
        super().__init__()
        check_frame_length(frame_length, levels)
        self.frame_length, self.levels, self.leaky_slope = frame_length, levels, leaky_slope
        self.weight_bits, self.act_bits = weight_bits, act_bits
        widths = [base_channels * 2 ** i for i in range(levels)]
        cin = 2
        for i, w in enumerate(widths):
            setattr(self, f"enc{i+1}_1", _conv(cin, w, 2))
            setattr(self, f"enc{i+1}_2", _conv(w, w, 1))
            cin = w
        self.bottle1 = _conv(cin, cin, 1)
        self.bottle2 = _conv(cin, cin, 1)
        for i in range(levels):
            out_w = widths[levels - 2 - i] if i < levels - 1 else widths[0]
            setattr(self, f"dec{i+1}_1", _conv(cin, out_w, 1))
            setattr(self, f"dec{i+1}_2", _conv(out_w, out_w, 1))
            cin = out_w
        self.final = _conv(cin, output_channels, 1)

    def _fake_quant(self, t: torch.Tensor, bits: int, name: str, amax,
                    per_channel: bool = False) -> torch.Tensor:
        """``fake_quantize_auto`` of ``t``, its scale from the global max
        where ``amax`` is given."""
        if amax is None:
            return fake_quantize_auto(t, bits, per_channel, channel_axis=0)
        with torch.no_grad():
            m = t.abs().amax(dim=(1, 2), keepdim=True) if per_channel else t.abs().max()
            scale = torch.clamp(amax(m, name), min=1e-8) / (2 ** (bits - 1) - 1)
        return fake_quantize(t, scale, bits)

    def _quant_act(self, h: torch.Tensor, name: str, amax=None) -> torch.Tensor:
        return self._fake_quant(h, self.act_bits, name, amax) if self.act_bits else h

    def _layer(self, name: str, h: torch.Tensor, conv_fn=None, amax=None) -> torch.Tensor:
        """Conv ``name``, then LeakyReLU and the activation's quantization."""
        return self._quant_act(F.leaky_relu(self._conv(name, h, conv_fn, amax), self.leaky_slope),
                               name, amax)

    def _conv(self, name: str, h: torch.Tensor, conv_fn=None, amax=None) -> torch.Tensor:
        conv = getattr(self, name)
        w = None
        if self.weight_bits:
            w = self._fake_quant(conv.weight, self.weight_bits, f"{name}.weight", amax,
                                 per_channel=True)
        return apply_conv(conv, name, h, conv_fn, w)

    def encode(self, x: torch.Tensor, conv_fn=None,
               amax=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The strided encoder: ``[B, L, 2]`` -> the bottleneck input and
        every level's skip activation, channels-first."""
        check_frame_length(x.shape[1], self.levels)
        h = self._quant_act(as_dtype(x.transpose(1, 2), self.enc1_1.weight.dtype), "input", amax)
        skips = []
        for i in range(self.levels):
            h = self._layer(f"enc{i+1}_1", h, conv_fn, amax)
            h = self._layer(f"enc{i+1}_2", h, conv_fn, amax)
            skips.append(h)
        return h, skips

    def decode(self, h: torch.Tensor, skips: List[torch.Tensor], conv_fn=None,
               amax=None) -> torch.Tensor:
        """The bottleneck and the decoder, consuming the skips: -> ``[B, L, 2]``."""
        h = self._layer("bottle1", h, conv_fn, amax)
        h = self._layer("bottle2", h, conv_fn, amax)
        for i in range(self.levels):
            h = self._layer(f"dec{i+1}_1", upsample_nearest_2x(h), conv_fn, amax)
            h = self._layer(f"dec{i+1}_2", h, conv_fn, amax)
            if i < self.levels - 1:
                h = self._quant_act(h + skips[self.levels - 2 - i], "skip", amax)
        return torch.tanh(self._conv("final", h, conv_fn, amax)).transpose(1, 2)

    def forward(self, x: torch.Tensor, conv_fn=None, amax=None) -> torch.Tensor:
        return self.decode(*self.encode(x, conv_fn, amax), conv_fn, amax)


class FullDiscriminator(nn.Module):
    """The scaled conditional critic: ``levels`` strided convs of width
    ``base * 2^min(i, 4)``, a sum over length in float32, dense -> 1."""

    def __init__(self, frame_length: int = 1024, levels: int = 5, base_channels: int = 32,
                 leaky_slope: float = 0.2):
        super().__init__()
        check_frame_length(frame_length, levels)
        self.frame_length, self.levels, self.leaky_slope = frame_length, levels, leaky_slope
        cin = 4
        for i in range(levels):
            w = base_channels * 2 ** min(i, 4)
            setattr(self, f"conv{i+1}", _conv(cin, w, 2))
            cin = w
        self.dense = nn.Linear(cin, 1)
        nn.init.xavier_uniform_(self.dense.weight)
        nn.init.zeros_(self.dense.bias)

    def forward(self, candidate: torch.Tensor, condition: torch.Tensor, conv_fn=None,
                pool=None) -> torch.Tensor:
        """``[B, L, 2] x [B, L, 2] -> [B, 1]`` critic score."""
        check_frame_length(candidate.shape[1], self.levels)
        dt = self.conv1.weight.dtype
        h = torch.cat([as_dtype(candidate, dt), as_dtype(condition, dt)], dim=-1).transpose(1, 2)
        for i in range(self.levels):
            name = f"conv{i+1}"
            h = F.leaky_relu(apply_conv(getattr(self, name), name, h, conv_fn), self.leaky_slope)
        pooled = as_dtype(h, torch.float32).sum(dim=-1)
        return self.dense(pooled if pool is None else pool(pooled))


# ------------------------------------------------------------------ sharding
TP_COLUMN, TP_ROW = 0, 1   # the weight dimension a rule shards: C_out or C_in


def _layer_of(name: str) -> str:
    return name.rsplit(".", 1)[0]


def _row_parallel(layer: str) -> bool:
    return layer.endswith("_2") or layer in ("final", "bottle1", "bottle2")


def unet_param_shardings(module: nn.Module, tp: int) -> Dict[str, Optional[int]]:
    """The tensor-parallel rule over ``tp`` ranks (reference
    ``full_unet.py:185-215``): each parameter's name -> the dimension of it
    that is sharded, or ``None`` (replicated). Megatron's alternation:
    ``*_1`` (and the critic's ``conv*``) kernels are column-parallel, their
    ``[C_out, C_in, k]`` weight and bias sharded on C_out (``TP_COLUMN``);
    ``*_2``, ``bottle1``, ``bottle2`` and ``final`` kernels are
    row-parallel, the weight sharded on C_in (``TP_ROW``) and the bias
    replicated (their partial outputs are summed over ``tp``); every other
    parameter, and any whose dimension ``tp`` does not divide, replicated."""
    spec = {}
    for name, p in module.named_parameters():
        layer, leaf = _layer_of(name), name.rsplit(".", 1)[1]
        dim = None
        if tp > 1:
            if layer.endswith("_1") or layer.startswith("conv"):
                if p.shape[0] % tp == 0:
                    dim = TP_COLUMN
            elif _row_parallel(layer) and leaf == "weight" and p.shape[1] % tp == 0:
                dim = TP_ROW
        spec[name] = dim
    return spec


def unet_param_shardings_rowparallel(module: nn.Module, tp: int) -> Dict[str, Optional[int]]:
    """The row-parallel half of ``unet_param_shardings`` alone (reference
    ``full_unet.py:218-252``): ``*_2``, ``final`` and ``bottle*`` weights
    sharded on C_in, everything else replicated. The reference keeps it for
    inference under sequence parallelism; training refuses any tensor
    sharding under ``sp`` (``parallel/gspmd.py``)."""
    return {name: (TP_ROW if tp > 1 and name.endswith(".weight") and _row_parallel(_layer_of(name))
                   and p.shape[1] % tp == 0 else None)
            for name, p in module.named_parameters()}
