"""Bit error rate through a signal enhancer (counterpart of
``ofdmgan_tpu/eval/ber.py:32-121``).

``ber_time_domain``: frames of +-a samples (QPSK-like, I and Q apart) in
AWGN, a hard sign decision per sample. ``ber_ofdm``: bits -> QPSK on every
subcarrier -> ``ifft * sqrt(L)`` -> AWGN -> joint max normalization ->
enhancer -> the normalization undone (``max_``) -> ``fft / sqrt(L)`` ->
nearest-point QPSK demodulation. ``ber_curve_snr_offset`` reads the SNR
gap between two BER curves at a target BER.

The draws are split from the arithmetic, as in ``signal/datagen.py``:
``make_time_domain_draws`` / ``make_ofdm_draws`` draw from a
``torch.Generator`` (``signs`` or ``bits``, and standard normals) and the
``*_from_draws`` functions are deterministic. The curves seed each SNR's
generator apart: from ``(seed, i)`` in the time domain and
``(seed, 1000 + i)`` for OFDM. ``time_domain_estimate`` and
``ofdm_received_symbols`` return the statistics the decisions are taken
on, so two devices' decisions can be compared where they are not ties.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..signal import qam
from ..utils.iq import complex_to_iq, iq_to_complex, joint_max_normalize
from .benchmark import device_of, seed_of


def make_time_domain_draws(gen: torch.Generator, n_frames: int,
                           frame_length: int) -> Dict[str, torch.Tensor]:
    """``signs`` (bool, P = 0.5) and ``noise`` (standard normal), both
    ``[n, L, 2]``."""
    kw = dict(generator=gen, device=gen.device)
    shape = (n_frames, frame_length, 2)
    return {"signs": torch.rand(shape, **kw) < 0.5, "noise": torch.randn(shape, **kw)}


@torch.no_grad()
def time_domain_estimate(draws: Dict[str, torch.Tensor], snr_db: float,
                         generator: Optional[Callable] = None, amplitude: float = 0.7):
    """The enhanced frames whose signs are the decisions."""
    signs = draws["signs"]
    clean = torch.where(signs, amplitude, -amplitude).float()
    snr = torch.tensor(snr_db, dtype=torch.float32, device=signs.device)
    noise_power = (clean ** 2).mean() / (10.0 ** (snr / 10.0))
    noisy = clean + torch.sqrt(noise_power) * draws["noise"]
    return generator(noisy) if generator is not None else noisy


def ber_time_domain_from_draws(draws, snr_db: float, generator=None) -> torch.Tensor:
    est = time_domain_estimate(draws, snr_db, generator)
    return ((est > 0) != draws["signs"]).float().mean()


def make_ofdm_draws(gen: torch.Generator, n_frames: int,
                    frame_length: int) -> Dict[str, torch.Tensor]:
    """``bits`` (int32, 2 per subcarrier) and the noise's ``nr``, ``ni``
    (standard normals ``[n, L]``)."""
    kw = dict(generator=gen, device=gen.device)
    bits = (torch.rand((n_frames, 2 * frame_length), **kw) < 0.5).to(torch.int32)
    return {"bits": bits, **{k: torch.randn((n_frames, frame_length), **kw)
                             for k in ("nr", "ni")}}


@torch.no_grad()
def ofdm_received_symbols(draws: Dict[str, torch.Tensor], snr_db: float,
                          generator: Optional[Callable] = None) -> torch.Tensor:
    """The demodulator's input symbols ``[n, L]`` after the enhancer."""
    bits = draws["bits"]
    L = bits.shape[-1] // 2
    syms = qam.modulate(bits, "QPSK")
    clean_c = torch.fft.ifft(syms, dim=-1) * math.sqrt(float(L))
    power = (clean_c.abs() ** 2).mean(dim=-1, keepdim=True)
    snr = torch.tensor(snr_db, dtype=torch.float32, device=bits.device)
    noise_power = power / (10.0 ** (snr / 10.0))
    noisy_c = clean_c + torch.sqrt(noise_power / 2.0) * torch.complex(draws["nr"], draws["ni"])
    clean_iq = complex_to_iq(clean_c).float()
    noisy_iq = complex_to_iq(noisy_c).float()
    noisy_n, _ = joint_max_normalize(noisy_iq, clean_iq)
    est = generator(noisy_n) if generator is not None else noisy_n
    # undo the normalization so that the demodulator sees physical amplitudes
    max_ = torch.maximum(noisy_iq.abs(), clean_iq.abs()).amax(dim=(1, 2), keepdim=True)
    return torch.fft.fft(iq_to_complex(est * max_), dim=-1) / math.sqrt(float(L))


def ber_ofdm_from_draws(draws, snr_db: float, generator=None) -> torch.Tensor:
    rx_bits = qam.demodulate(ofdm_received_symbols(draws, snr_db, generator), "QPSK")
    return (rx_bits != draws["bits"]).float().mean()


def ber_time_domain(generator, snr_values, n_frames: int = 2048, frame_length: int = 16,
                    seed: int = 0, device=None) -> Dict[float, float]:
    """BER per SNR; on ``device``, by default the generator's or the GPU."""
    dev = device_of(generator, device)
    out = {}
    for i, s in enumerate(snr_values):
        gen = torch.Generator(device=dev).manual_seed(seed_of(seed, i))
        draws = make_time_domain_draws(gen, n_frames, frame_length)
        out[float(s)] = float(ber_time_domain_from_draws(draws, float(s), generator))
    return out


def ber_ofdm(generator, snr_values, n_frames: int = 2048, frame_length: int = 16,
             seed: int = 0, device=None) -> Dict[float, float]:
    dev = device_of(generator, device)
    out = {}
    for i, s in enumerate(snr_values):
        gen = torch.Generator(device=dev).manual_seed(seed_of(seed, 1000 + i))
        draws = make_ofdm_draws(gen, n_frames, frame_length)
        out[float(s)] = float(ber_ofdm_from_draws(draws, float(s), generator))
    return out


def ber_curve_snr_offset(curve_a: Dict[float, float], curve_b: Dict[float, float],
                         target_ber: float = 1e-2) -> Optional[float]:
    """SNR offset (dB) between two BER curves at ``target_ber``: positive
    when curve_a needs more SNR than curve_b (a is worse)."""

    def snr_at(curve):
        snrs = sorted(curve)
        bers = [max(curve[s], 1e-12) for s in snrs]
        lb = np.log10(bers)
        t = np.log10(target_ber)
        for i in range(len(snrs) - 1):
            if (lb[i] - t) * (lb[i + 1] - t) <= 0 and lb[i] != lb[i + 1]:
                f = (t - lb[i]) / (lb[i + 1] - lb[i])
                return snrs[i] + f * (snrs[i + 1] - snrs[i])
        return None

    a, b = snr_at(curve_a), snr_at(curve_b)
    if a is None or b is None:
        return None
    return a - b
