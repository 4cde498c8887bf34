"""The two CWGAN-GP model pairs as plain PyTorch functions of their parameters.

Frozen copies of the layer equations of the mini pair (the reference
repository's ``models/generator.py`` and ``models/discriminator.py``) and of
the full 1-D U-Net pair (its ``export/generator/metadata.json`` model).
Every convolution has kernel 3 and zero padding 1; LeakyReLU follows every
convolution but the generator's last, whose output goes through tanh; the
upsample is nearest-neighbour x2; a critic scores the candidate against
its condition, concatenated on the channel axis, with a sum over time
before one dense output. Frames are channels-last ``[B, L, 2]`` (I/Q).

Parameters are a dict from the layer names below (``<layer>.weight``,
``<layer>.bias``) to tensors: conv weights ``[C_out, C_in, 3]``, dense
``[1, C]``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _up2(h: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 along the last (length) axis."""
    return h.unsqueeze(-1).expand(*h.shape, 2).reshape(*h.shape[:-1], 2 * h.shape[-1])


def _conv(p: Params, name: str, h: torch.Tensor, stride: int) -> torch.Tensor:
    return F.conv1d(h, p[f"{name}.weight"], p[f"{name}.bias"], stride=stride, padding=1)


def _conv_layers(config: dict) -> Tuple[List[Tuple[str, int, int]], List[Tuple[str, int, int]]]:
    """The (name, C_in, C_out) of every convolution of the generator and of
    the critic, in order."""
    if config["family"] == "mini":
        g, d = config["generator"], config["critic"]
        e, b, dec = g["enc1_channels"], g["bottleneck_channels"], g["dec1_channels"]
        gen = [("enc1", 2, e), ("bottleneck", e, b), ("dec1", b, dec), ("out_conv", dec, 2)]
        crit = [("conv1", 4, d["conv1_channels"]),
                ("conv2", d["conv1_channels"], d["conv2_channels"])]
        return gen, crit
    levels, base = config["levels"], config["base_channels"]
    widths = [base * 2 ** i for i in range(levels)]
    gen, cin = [], 2
    for i, w in enumerate(widths):
        gen += [(f"enc{i+1}_1", cin, w), (f"enc{i+1}_2", w, w)]
        cin = w
    gen += [("bottle1", cin, cin), ("bottle2", cin, cin)]
    for i in range(levels):
        out_w = widths[levels - 2 - i] if i < levels - 1 else widths[0]
        gen += [(f"dec{i+1}_1", cin, out_w), (f"dec{i+1}_2", out_w, out_w)]
        cin = out_w
    gen.append(("final", cin, 2))
    crit, cin = [], 4
    for i in range(levels):
        w = base * 2 ** min(i, 4)
        crit.append((f"conv{i+1}", cin, w))
        cin = w
    return gen, crit


def param_shapes(config: dict) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """``{"generator": {name: shape}, "critic": {name: shape}}`` of a
    configuration file's model pair."""
    gen, crit = _conv_layers(config)
    shapes = {"generator": {}, "critic": {}}
    for net, layers in (("generator", gen), ("critic", crit)):
        for name, cin, cout in layers:
            shapes[net][f"{name}.weight"] = (cout, cin, 3)
            shapes[net][f"{name}.bias"] = (cout,)
    c_last = crit[-1][2]
    shapes["critic"]["dense.weight"] = (1, c_last)
    shapes["critic"]["dense.bias"] = (1,)
    return shapes


def generator(config: dict, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Noisy frames ``[B, L, 2]`` -> enhanced ``[B, L, 2]``."""
    slope = config["generator"]["leaky_slope"] if config["family"] == "mini" \
        else config["leaky_slope"]
    act = lambda h: F.leaky_relu(h, slope)  # noqa: E731
    h = x.transpose(1, 2)
    if config["family"] == "mini":
        # enc1 (s2) -> bottleneck (s2) -> up -> dec1, + enc1 -> up -> out_conv
        e1 = act(_conv(p, "enc1", h, 2))
        b = act(_conv(p, "bottleneck", e1, 2))
        d1 = act(_conv(p, "dec1", _up2(b), 1))
        out = _conv(p, "out_conv", _up2(d1 + e1), 1)
        return torch.tanh(out).transpose(1, 2)
    levels = config["levels"]
    skips = []
    for i in range(levels):
        h = act(_conv(p, f"enc{i+1}_1", h, 2))
        h = act(_conv(p, f"enc{i+1}_2", h, 1))
        skips.append(h)
    h = act(_conv(p, "bottle1", h, 1))
    h = act(_conv(p, "bottle2", h, 1))
    for i in range(levels):
        h = act(_conv(p, f"dec{i+1}_1", _up2(h), 1))
        h = act(_conv(p, f"dec{i+1}_2", h, 1))
        if i < levels - 1:
            h = h + skips[levels - 2 - i]
    return torch.tanh(_conv(p, "final", h, 1)).transpose(1, 2)


def critic(config: dict, p: Params, candidate: torch.Tensor,
           condition: torch.Tensor) -> torch.Tensor:
    """``[B, L, 2] x [B, L, 2] -> [B, 1]``: strided convolutions, a sum
    over time, one dense output."""
    slope = config["critic"]["leaky_slope"] if config["family"] == "mini" \
        else config["leaky_slope"]
    _, layers = _conv_layers(config)
    h = torch.cat([candidate, condition], dim=-1).transpose(1, 2)
    for name, _, _ in layers:
        h = F.leaky_relu(_conv(p, name, h, 2), slope)
    return F.linear(h.sum(dim=-1), p["dense.weight"], p["dense.bias"])
