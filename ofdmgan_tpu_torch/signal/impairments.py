"""RF front-end impairments with explicit random draws.

Counterpart of ``ofdmgan_tpu/signal/impairments.py:26-131``. The JAX
functions draw from a PRNG key; these take the draws as tensors, so a test can
feed both packages the same numbers. The default chain is Rapp PA -> IQ
imbalance -> Wiener phase noise; the Saleh PA, DC offset and CFO stages are
not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ImpairmentConfig:
    """Static impairment settings (defaults of the reference's apply_all)."""

    pa_enabled: bool = True
    pa_model: str = "rapp"          # "rapp" ("saleh" is not ported yet)
    pa_saturation: float = 1.0
    pa_smoothness: float = 3.0
    iq_enabled: bool = True
    iq_amplitude_db: float = 1.0
    iq_phase_deg: float = 5.0
    phase_noise_enabled: bool = True
    phase_noise_dbchz: float = -80.0
    sample_rate: float = 1e6
    dc_enabled: bool = False
    dc_offset_i: float = 0.01
    dc_offset_q: float = 0.01
    cfo_enabled: bool = False
    cfo_hz: float = 100.0


def pa_rapp(x: torch.Tensor, saturation: float = 1.0, smoothness: float = 3.0) -> torch.Tensor:
    """Rapp solid-state PA AM/AM compression; the phase is kept."""
    ratio = x.abs() / saturation
    gain = (1.0 + ratio ** (2.0 * smoothness)) ** (-1.0 / (2.0 * smoothness))
    return x * gain


def iq_imbalance(x: torch.Tensor, amplitude_db: float = 1.0, phase_deg: float = 5.0) -> torch.Tensor:
    """I' = I, Q' = g (cos(phi) Q + sin(phi) I), g = 10^(dB/20)."""
    g = 10.0 ** (amplitude_db / 20.0)
    phi = math.radians(phase_deg)
    q_out = g * (math.cos(phi) * x.imag + math.sin(phi) * x.real)
    return torch.complex(x.real, q_out)


def phase_noise_sigma(power_dbchz: float = -80.0, sample_rate: float = 1e6) -> float:
    """Per-sample standard deviation of the Wiener phase increments."""
    return math.sqrt(10.0 ** (power_dbchz / 10.0) * sample_rate)


def phase_noise(x: torch.Tensor, increments: torch.Tensor,
                power_dbchz: float = -80.0, sample_rate: float = 1e6) -> torch.Tensor:
    """Wiener phase noise over the trailing axis from standard-normal
    ``increments`` shaped like ``x``."""
    theta = torch.cumsum(phase_noise_sigma(power_dbchz, sample_rate) * increments, dim=-1)
    return x * torch.polar(torch.ones_like(theta), theta)


def apply_all(x: torch.Tensor, cfg: ImpairmentConfig, pn_increments: torch.Tensor) -> torch.Tensor:
    """The enabled impairments in the reference's order: PA -> IQ -> PN."""
    if (cfg.pa_enabled and cfg.pa_model != "rapp") or cfg.dc_enabled or cfg.cfo_enabled:
        raise NotImplementedError(
            "the Saleh PA, DC offset and CFO impairments are not ported yet")
    out = x
    if cfg.pa_enabled:
        out = pa_rapp(out, cfg.pa_saturation, cfg.pa_smoothness)
    if cfg.iq_enabled:
        out = iq_imbalance(out, cfg.iq_amplitude_db, cfg.iq_phase_deg)
    if cfg.phase_noise_enabled:
        out = phase_noise(out, pn_increments, cfg.phase_noise_dbchz, cfg.sample_rate)
    return out
