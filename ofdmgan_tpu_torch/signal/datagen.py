"""Synthetic OFDM training batches (counterpart of
``ofdmgan_tpu/signal/datagen.py:73-100``).

Per frame: spectrum s ~ CN(0,1) per bin; clean = ifft(s)·sqrt(L);
distorted = impairments(clean) when ``nonlinear``; snr ~ U(snr_min,
snr_max); noisy = channel(distorted, snr); (noisy, clean) jointly
max-normalized. The clean target is the pre-impairment frame, as in the
reference. Returns channels-last ``[B, L, 2]`` float32.

``synthetic_batch_from_draws`` takes every random number as a tensor:
``zr``, ``zi`` (spectrum), ``pn`` (phase-noise increments), ``nr``, ``ni``
(channel noise), all standard normals ``[B, L]``, and ``u`` ``[B]`` uniform
on (0, 1) for the SNR.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from . import channel as channel_lib
from . import impairments as imp_lib
from .ofdm import ofdm_like_frame
from ..utils.iq import complex_to_iq, joint_max_normalize


@dataclasses.dataclass(frozen=True)
class DatagenConfig:
    frame_length: int = 16
    snr_min: float = 0.0
    snr_max: float = 30.0
    channel: channel_lib.ChannelConfig = channel_lib.ChannelConfig("awgn")
    nonlinear: bool = False
    impairments: imp_lib.ImpairmentConfig = imp_lib.ImpairmentConfig()


def make_draws(gen: torch.Generator, batch_size: int, frame_length: int) -> Dict[str, torch.Tensor]:
    """Every random number one batch needs, on ``gen``'s device."""
    shape = (batch_size, frame_length)
    kw = dict(generator=gen, device=gen.device, dtype=torch.float32)
    draws = {k: torch.randn(shape, **kw) for k in ("zr", "zi", "pn", "nr", "ni")}
    draws["u"] = torch.rand((batch_size,), **kw)
    return draws


def synthetic_batch_from_draws(draws: Dict[str, torch.Tensor], cfg: DatagenConfig):
    freq = torch.complex(draws["zr"], draws["zi"]) / math.sqrt(2.0)
    clean = ofdm_like_frame(freq)
    distorted = clean
    if cfg.nonlinear:
        distorted = imp_lib.apply_all(clean, cfg.impairments, draws["pn"])
    snr = cfg.snr_min + (cfg.snr_max - cfg.snr_min) * draws["u"]
    noisy, _ = channel_lib.apply(distorted, snr, cfg.channel, draws["nr"], draws["ni"])
    noisy_iq, clean_iq = joint_max_normalize(complex_to_iq(noisy), complex_to_iq(clean))
    return {"noisy": noisy_iq, "clean": clean_iq, "snr": snr}


def synthetic_batch(gen: torch.Generator, batch_size: int, cfg: DatagenConfig):
    """A batch of (noisy, clean, snr) frames on ``gen``'s device."""
    return synthetic_batch_from_draws(make_draws(gen, batch_size, cfg.frame_length), cfg)
