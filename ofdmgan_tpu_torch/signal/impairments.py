"""RF front-end impairments with explicit random draws.

Counterpart of ``ofdmgan_tpu/signal/impairments.py:26-131``. The JAX
functions draw from a PRNG key; these take the draws as tensors, so a test can
feed both packages the same numbers. ``apply_all`` runs the enabled stages
in the reference's order: PA (Rapp or Saleh) -> IQ imbalance -> Wiener phase
noise -> DC offset -> CFO.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ImpairmentConfig:
    """Static impairment settings (defaults of the reference's apply_all)."""

    pa_enabled: bool = True
    pa_model: str = "rapp"          # "rapp" | "saleh"
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


def pa_saleh(x: torch.Tensor, alpha_a: float = 2.1587, beta_a: float = 1.1517,
             alpha_p: float = 4.0033, beta_p: float = 9.1040) -> torch.Tensor:
    """Saleh TWT PA: A(r) = aa r/(1 + ba r^2) and the phase turned by
    Phi(r) = ap r^2/(1 + bp r^2); ``angle(0)`` is 0, as ``jnp.angle``'s."""
    r = x.abs()
    r2 = r * r
    a_out = alpha_a * r / (1.0 + beta_a * r2)
    phi = alpha_p * r2 / (1.0 + beta_p * r2)
    return torch.polar(a_out, torch.angle(x) + phi)


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


def dc_offset(x: torch.Tensor, offset_i: float = 0.01, offset_q: float = 0.01) -> torch.Tensor:
    """Add a DC term proportional to the frame's RMS amplitude."""
    mag = torch.sqrt((x.abs() ** 2).mean(dim=-1, keepdim=True))
    return x + mag * complex(offset_i, offset_q)


def cfo(x: torch.Tensor, cfo_hz: float = 100.0, sample_rate: float = 1e6) -> torch.Tensor:
    """Carrier frequency offset: sample n turned by 2 pi f n / fs."""
    n = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    theta = (2.0 * math.pi * cfo_hz / sample_rate) * n
    return x * torch.polar(torch.ones_like(theta), theta)


def apply_all(x: torch.Tensor, cfg: ImpairmentConfig, pn_increments: torch.Tensor) -> torch.Tensor:
    """The enabled impairments in the reference's order: PA -> IQ -> PN ->
    DC -> CFO."""
    out = x
    if cfg.pa_enabled:
        if cfg.pa_model == "rapp":
            out = pa_rapp(out, cfg.pa_saturation, cfg.pa_smoothness)
        elif cfg.pa_model == "saleh":
            out = pa_saleh(out)
        else:
            raise ValueError(f"unknown pa_model {cfg.pa_model}")
    if cfg.iq_enabled:
        out = iq_imbalance(out, cfg.iq_amplitude_db, cfg.iq_phase_deg)
    if cfg.phase_noise_enabled:
        out = phase_noise(out, pn_increments, cfg.phase_noise_dbchz, cfg.sample_rate)
    if cfg.dc_enabled:
        out = dc_offset(out, cfg.dc_offset_i, cfg.dc_offset_q)
    if cfg.cfo_enabled:
        out = cfo(out, cfg.cfo_hz, cfg.sample_rate)
    return out
