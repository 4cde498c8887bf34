"""Wireless channels with explicit random draws: AWGN, flat Rayleigh, Rician
and tapped multipath.

Counterpart of ``ofdmgan_tpu/signal/channel.py:27-124``. The JAX functions
draw from a PRNG key; these take the draws as tensors (``make_draws`` makes
them), so a test can feed both packages the same numbers:

* ``nr``, ``ni``: standard normals shaped like the frame (the AWGN);
* ``hr``, ``hi``: standard normals, one per frame (Rayleigh, Rician) or
  ``[..., n_taps]`` (multipath), the fading taps' CN(0, 1) parts;
* ``theta``: the Rician line-of-sight phase, uniform on (0, 2 pi).

The SNR is measured after fading: the noise is scaled to the faded frame.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    kind: str = "awgn"  # "awgn" | "rayleigh" | "rician" | "multipath" | "none"
    k_factor: float = 3.0
    delays: Tuple[int, ...] = (0, 1, 2)
    powers: Tuple[float, ...] = (1.0, 0.5, 0.25)


def awgn(x: torch.Tensor, snr_db: torch.Tensor, nr: torch.Tensor, ni: torch.Tensor):
    """y = x + n, n ~ CN(0, P/10^(SNR/10)) with P the per-frame mean power of
    ``x``; ``nr``/``ni`` are standard normals shaped like ``x``."""
    power = (x.abs() ** 2).mean(dim=-1, keepdim=True)
    noise_power = power / (10.0 ** (snr_db[..., None] / 10.0))
    std = torch.sqrt(noise_power / 2.0)
    return x + std * torch.complex(nr, ni), {"noise_power": noise_power[..., 0]}


def _cn01(hr: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """CN(0, 1) from two standard normals: (hr + j hi) / sqrt(2)."""
    return torch.complex(hr, hi) / math.sqrt(2.0)


def rayleigh(x, snr_db, hr, hi, nr, ni):
    """One CN(0, 1) tap per frame, then AWGN on the faded frame."""
    h = _cn01(hr, hi)
    y, info = awgn(h[..., None] * x, snr_db, nr, ni)
    info["h"] = h
    return y, info


def rician(x, snr_db, theta, hr, hi, nr, ni, k_factor: float = 3.0):
    """h = sqrt(K/(K+1)) e^{j theta} + sqrt(1/(K+1)) CN(0, 1) per frame, then
    AWGN on the faded frame."""
    h_los = math.sqrt(k_factor / (k_factor + 1.0)) * torch.polar(torch.ones_like(theta), theta)
    h = h_los + math.sqrt(1.0 / (k_factor + 1.0)) * _cn01(hr, hi)
    y, info = awgn(h[..., None] * x, snr_db, nr, ni)
    info["h"] = h
    return y, info


def multipath_cir(hr, hi, delays=(0, 1, 2), powers=(1.0, 0.5, 0.25)) -> torch.Tensor:
    """Channel impulse response ``[..., max(delays) + 1]``: per-tap Rayleigh
    draws ``hr``/``hi`` ``[..., len(delays)]`` scaled by the square roots of
    the normalised tap powers, placed at their delays."""
    # the scales in float32 on the host, and one tap at a time: nothing is
    # copied to the device (a CUDA graph holds this step)
    p = np.asarray(powers, np.float32)
    scales = np.sqrt(p / p.sum(dtype=np.float32))
    taps = _cn01(hr, hi)
    h = torch.zeros(hr.shape[:-1] + (max(delays) + 1,), dtype=torch.complex64, device=hr.device)
    for i, d in enumerate(delays):
        h[..., d] = taps[..., i] * float(scales[i])
    return h


def convolve_same(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``numpy.convolve(x, h, mode="same")`` over the trailing axis, batched
    over the leading ones: a true convolution (taps not flipped back, unlike
    ``conv1d``'s cross-correlation), the centre ``max(L, K)`` samples of the
    full result, which start at ``(min(L, K) - 1) // 2``."""
    L, K = x.shape[-1], h.shape[-1]
    full = torch.zeros(x.shape[:-1] + (L + K - 1,), dtype=torch.complex64, device=x.device)
    for k in range(K):
        full[..., k:k + L] += h[..., k:k + 1] * x
    start = (min(L, K) - 1) // 2
    return full[..., start:start + max(L, K)]


def multipath(x, snr_db, hr, hi, nr, ni, delays=(0, 1, 2), powers=(1.0, 0.5, 0.25)):
    """Tapped delay line with per-tap Rayleigh fading ("same"-mode
    convolution), then AWGN on the faded frame."""
    h = multipath_cir(hr, hi, delays, powers)
    y, info = awgn(convolve_same(x, h), snr_db, nr, ni)
    info["h"] = h
    return y, info


def draw_shapes(cfg: ChannelConfig, frames: Tuple[int, ...]) -> Dict[str, Tuple[int, ...]]:
    """The shape of each fading draw of ``cfg`` for frames of batch shape
    ``frames`` (the AWGN's ``nr``/``ni`` are not listed)."""
    if cfg.kind == "rayleigh":
        return {"hr": frames, "hi": frames}
    if cfg.kind == "rician":
        return {"theta": frames, "hr": frames, "hi": frames}
    if cfg.kind == "multipath":
        taps = frames + (len(cfg.delays),)
        return {"hr": taps, "hi": taps}
    if cfg.kind in ("awgn", "none"):
        return {}
    raise ValueError(f"Unknown channel kind: {cfg.kind}")


def make_draws(gen: torch.Generator, cfg: ChannelConfig, frames: Tuple[int, ...]):
    """The fading draws of ``cfg`` from ``gen``, on its device."""
    kw = dict(generator=gen, device=gen.device, dtype=torch.float32)
    draws = {}
    for key, shape in draw_shapes(cfg, frames).items():
        draws[key] = (2.0 * math.pi) * torch.rand(shape, **kw) if key == "theta" \
            else torch.randn(shape, **kw)
    return draws


def apply(x: torch.Tensor, snr_db: torch.Tensor, cfg: ChannelConfig,
          draws: Dict[str, torch.Tensor]):
    """The channel of ``cfg`` on complex frames ``x`` ``[..., L]``, from
    ``draws`` (``nr``, ``ni`` and the fading draws of ``draw_shapes``)."""
    if cfg.kind == "awgn":
        return awgn(x, snr_db, draws["nr"], draws["ni"])
    if cfg.kind == "rayleigh":
        return rayleigh(x, snr_db, draws["hr"], draws["hi"], draws["nr"], draws["ni"])
    if cfg.kind == "rician":
        return rician(x, snr_db, draws["theta"], draws["hr"], draws["hi"], draws["nr"],
                      draws["ni"], cfg.k_factor)
    if cfg.kind == "multipath":
        return multipath(x, snr_db, draws["hr"], draws["hi"], draws["nr"], draws["ni"],
                         cfg.delays, cfg.powers)
    if cfg.kind == "none":
        return x, {}
    raise ValueError(f"Unknown channel kind: {cfg.kind}")
