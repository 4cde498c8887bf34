"""Synthetic OFDM training batches (counterpart of
``ofdmgan_tpu/signal/datagen.py:37-189``).

Per frame: spectrum s ~ CN(0,1) per bin; clean = ifft(s)·sqrt(L);
distorted = impairments(clean) when ``nonlinear``; snr ~ U(snr_min,
snr_max); noisy = channel(distorted, snr); (noisy, clean) jointly
max-normalized. The clean target is the pre-impairment frame, as in the
reference. Returns channels-last ``[B, L, 2]`` float32.

``synthetic_batch_from_draws`` takes every random number as a tensor:
``zr``, ``zi`` (spectrum), ``pn`` (phase-noise increments), ``nr``, ``ni``
(channel noise), all standard normals ``[B, L]``, ``u`` ``[B]`` uniform on
(0, 1) for the SNR, and the fading channels' draws of
``channel.draw_shapes`` (``hr``, ``hi``, ``theta``), drawn after the rest.

``synthetic_batch_flat`` is the reference's matmul-form datagen for the
linear AWGN configuration (``ofdmgan_tpu/signal/datagen.py:106-182``):
the same frames as flat ``[B, 2L]`` interleaved I/Q, the inverse DFT and
the interleave as float32 products with constant matrices instead of an
FFT. It is ported for parity with the reference and is on no training
path: the flat step takes its batches as the module step does, from the
datagen kernel (``ops/datagen_kernel.py``, the same function, whose
``[B, L, 2]`` output viewed as ``[B, 2L]`` is this layout) or from
``synthetic_batch``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict

import numpy as np
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

    @staticmethod
    def make(frame_length: int = 16, snr_range=(0.0, 30.0), channel_type: str = "awgn",
             nonlinear: bool = False, pa_saturation: float = 1.0,
             iq_imbalance_db: float = 1.0, iq_phase_deg: float = 5.0,
             phase_noise_dbchz: float = -80.0) -> "DatagenConfig":
        """The reference's constructor (SyntheticOFDMDataset's signature)."""
        return DatagenConfig(
            frame_length=frame_length,
            snr_min=float(snr_range[0]),
            snr_max=float(snr_range[1]),
            channel=channel_lib.ChannelConfig(channel_type),
            nonlinear=nonlinear,
            impairments=imp_lib.ImpairmentConfig(
                pa_saturation=pa_saturation, iq_amplitude_db=iq_imbalance_db,
                iq_phase_deg=iq_phase_deg, phase_noise_dbchz=phase_noise_dbchz),
        )


def make_draws(gen: torch.Generator, batch_size: int, frame_length: int,
               channel: channel_lib.ChannelConfig | None = None) -> Dict[str, torch.Tensor]:
    """Every random number one batch needs, on ``gen``'s device."""
    shape = (batch_size, frame_length)
    kw = dict(generator=gen, device=gen.device, dtype=torch.float32)
    draws = {k: torch.randn(shape, **kw) for k in ("zr", "zi", "pn", "nr", "ni")}
    draws["u"] = torch.rand((batch_size,), **kw)
    if channel is not None:
        draws.update(channel_lib.make_draws(gen, channel, (batch_size,)))
    return draws


def synthetic_batch_from_draws(draws: Dict[str, torch.Tensor], cfg: DatagenConfig):
    freq = torch.complex(draws["zr"], draws["zi"]) / math.sqrt(2.0)
    clean = ofdm_like_frame(freq)
    distorted = clean
    if cfg.nonlinear:
        distorted = imp_lib.apply_all(clean, cfg.impairments, draws["pn"])
    snr = cfg.snr_min + (cfg.snr_max - cfg.snr_min) * draws["u"]
    noisy, _ = channel_lib.apply(distorted, snr, cfg.channel, draws)
    noisy_iq, clean_iq = joint_max_normalize(complex_to_iq(noisy), complex_to_iq(clean))
    return {"noisy": noisy_iq, "clean": clean_iq, "snr": snr}


def synthetic_batch(gen: torch.Generator, batch_size: int, cfg: DatagenConfig):
    """A batch of (noisy, clean, snr) frames on ``gen``'s device."""
    return synthetic_batch_from_draws(
        make_draws(gen, batch_size, cfg.frame_length, cfg.channel), cfg)


@functools.lru_cache(maxsize=None)
def _flat_dft_mats(L: int, device: torch.device):
    """``(Mr, Mi, Er, Ei)``, ``[L, 2L]`` float32 matrices mapping the normal
    draws to flat frames: ``clean = zr @ Mr + zi @ Mi`` is
    ``ifft((zr + j zi) / sqrt(2)) * sqrt(L)`` as interleaved I/Q, and
    ``nr @ Er + ni @ Ei`` interleaves the noise draws. Kept per device."""
    t = np.arange(L)[:, None]
    k = np.arange(L)[None, :]
    c = np.exp(2j * np.pi * t * k / L)   # c[t, k] = e^{+j 2 pi t k / L}
    s = 1.0 / np.sqrt(2.0 * L)   # (1/L from the ifft) * sqrt(L) / sqrt(2)
    mr, mi, er, ei = (np.zeros((L, 2 * L), np.float32) for _ in range(4))
    for tt in range(L):
        for kk in range(L):
            mr[kk, 2 * tt] = s * c[tt, kk].real
            mr[kk, 2 * tt + 1] = s * c[tt, kk].imag
            mi[kk, 2 * tt] = -s * c[tt, kk].imag
            mi[kk, 2 * tt + 1] = s * c[tt, kk].real
        er[tt, 2 * tt] = 1.0
        ei[tt, 2 * tt + 1] = 1.0
    return tuple(torch.from_numpy(m).to(device) for m in (mr, mi, er, ei))


def check_flat_config(cfg: DatagenConfig) -> None:
    if cfg.nonlinear or cfg.channel.kind != "awgn":
        raise ValueError("synthetic_batch_flat covers the linear AWGN config; "
                         "use synthetic_batch otherwise")


def synthetic_batch_flat_from_draws(draws: Dict[str, torch.Tensor], cfg: DatagenConfig):
    """Flat ``[B, 2L]`` frames from the draws ``zr``, ``zi``, ``nr``, ``ni``
    ``[B, L]`` and ``u`` ``[B]`` (the reference's stream: the spectrum, the
    SNR, then the channel's noise)."""
    check_flat_config(cfg)
    L = cfg.frame_length
    mr, mi, er, ei = _flat_dft_mats(L, draws["zr"].device)
    clean = draws["zr"] @ mr + draws["zi"] @ mi   # unit mean power
    snr = cfg.snr_min + (cfg.snr_max - cfg.snr_min) * draws["u"]
    # channel.awgn's noise: per-frame power of the channel input, sigma per dimension
    power = (clean * clean).sum(dim=-1, keepdim=True) / L
    std = torch.sqrt(power / torch.pow(10.0, snr[:, None] / 10.0) / 2.0)
    noisy = clean + std * (draws["nr"] @ er + draws["ni"] @ ei)
    m = torch.maximum(noisy.abs().amax(dim=-1, keepdim=True),
                      clean.abs().amax(dim=-1, keepdim=True)).clamp_min(1e-12)
    return {"noisy": noisy / m, "clean": clean / m, "snr": snr}


def synthetic_batch_flat(gen: torch.Generator, batch_size: int, cfg: DatagenConfig):
    """A flat ``[B, 2L]`` batch of the linear AWGN configuration on ``gen``'s device."""
    check_flat_config(cfg)
    return synthetic_batch_flat_from_draws(make_draws(gen, batch_size, cfg.frame_length), cfg)


def test_batch_at_snr_from_draws(draws: Dict[str, torch.Tensor], snr_db: float,
                                 cfg: DatagenConfig):
    """A fixed-SNR evaluation batch from injected draws: the training
    pipeline with ``snr_min = snr_max = snr_db``."""
    fixed = dataclasses.replace(cfg, snr_min=float(snr_db), snr_max=float(snr_db))
    out = synthetic_batch_from_draws(draws, fixed)
    out["snr"] = torch.full_like(out["snr"], float(snr_db))
    return out


def test_batch_at_snr(gen: torch.Generator, batch_size: int, snr_db: float, cfg: DatagenConfig):
    """A fixed-SNR evaluation batch (reference utils/dataset.py:326-383)."""
    return test_batch_at_snr_from_draws(
        make_draws(gen, batch_size, cfg.frame_length, cfg.channel), snr_db, cfg)
