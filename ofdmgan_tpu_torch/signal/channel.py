"""AWGN channel with explicit noise draws.

Counterpart of ``ofdmgan_tpu/signal/channel.py:27-48``. Fading channels
(Rayleigh, Rician, multipath) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    kind: str = "awgn"  # "awgn" | "none" (fading kinds are not ported yet)


def awgn(x: torch.Tensor, snr_db: torch.Tensor, nr: torch.Tensor, ni: torch.Tensor):
    """y = x + n, n ~ CN(0, P/10^(SNR/10)) with P the per-frame mean power of
    ``x``; ``nr``/``ni`` are standard normals shaped like ``x``."""
    power = (x.abs() ** 2).mean(dim=-1, keepdim=True)
    noise_power = power / (10.0 ** (snr_db[..., None] / 10.0))
    std = torch.sqrt(noise_power / 2.0)
    return x + std * torch.complex(nr, ni), {"noise_power": noise_power[..., 0]}


def apply(x: torch.Tensor, snr_db: torch.Tensor, cfg: ChannelConfig,
          nr: torch.Tensor, ni: torch.Tensor):
    if cfg.kind == "awgn":
        return awgn(x, snr_db, nr, ni)
    if cfg.kind == "none":
        return x, {}
    if cfg.kind in ("rayleigh", "rician", "multipath"):
        raise NotImplementedError(f"the {cfg.kind} channel is not ported yet")
    raise ValueError(f"Unknown channel kind: {cfg.kind}")
