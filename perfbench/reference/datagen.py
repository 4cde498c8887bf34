"""The synthetic OFDM batch, in plain PyTorch float64 (on any device).

A frozen copy of the arithmetic of the port's datagen kernel
(``csrc/datagen.cu``), computed plainly: the frame's draws from its
Philox4x32-10 stream, a CN(0, 1) spectrum, the inverse DFT times
``sqrt(L)``, optionally the nonlinear chain (Rapp PA, IQ imbalance, Wiener
phase noise), the SNR uniform, AWGN at that SNR over the distorted frame's
power, and the joint max-normalisation of (noisy, clean). The clean target
is the frame before the impairments.

The stream of frame ``f`` under the seed ``s`` (a 64-bit word, its low half
the key's first word) is counted by ``(f, 0, stream, i)``:

* stream 0, call ``i`` (``i < L/2``): samples ``2i`` and ``2i + 1`` of the
  spectrum, one Box-Muller pair each (real, imaginary);
* stream 1, call ``j`` (``j < ceil(L/4)``), the phase increments: two
  Box-Muller pairs ``a``, ``c`` give ``pn[2j] = a.re``, ``pn[2j + 1] =
  c.re``, ``pn[L/2 + 2j] = a.im``, ``pn[L/2 + 2j + 1] = c.im`` (where they
  lie inside the frame);
* stream 2, call ``i``: the channel noise of samples ``2i`` and ``2i + 1``,
  as stream 0;
* stream 3, call 0: the first word's uniform is the SNR's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .philox import box_muller, philox4x32_10, uniform01

F64 = torch.float64


def _pairs(seed: int, B: int, stream: int, calls: int, device: torch.device):
    f = torch.arange(B, dtype=torch.int64, device=device)[:, None]
    i = torch.arange(calls, dtype=torch.int64, device=device)[None, :]
    return philox4x32_10((f, 0, stream, i), (seed & 0xFFFFFFFF, seed >> 32))


def normals_from_seed(seed: int, B: int, L: int, nonlinear: bool,
                      device: torch.device | str = "cpu") -> Dict[str, torch.Tensor]:
    """The draws of ``B`` frames of ``L`` samples under the 64-bit seed
    ``seed``: normals ``zr``, ``zi``, ``nr``, ``ni`` (and ``pn`` when
    ``nonlinear``) ``[B, L]`` and the uniform ``u`` ``[B]``, float64 on
    ``device``."""
    P = L // 2
    out = {}
    for stream, (re, im) in ((0, ("zr", "zi")), (2, ("nr", "ni"))):
        b = _pairs(seed, B, stream, P, device)
        z0, z1 = box_muller(b[0], b[1]), box_muller(b[2], b[3])
        for key, k in ((re, 0), (im, 1)):
            x = torch.empty((B, L), dtype=F64, device=device)
            x[:, 0::2], x[:, 1::2] = z0[k], z1[k]
            out[key] = x
    if nonlinear:
        calls = (L + 3) // 4
        b = _pairs(seed, B, 1, calls, device)
        a, c = box_muller(b[0], b[1]), box_muller(b[2], b[3])
        pn = torch.zeros((B, L), dtype=F64, device=device)
        j = torch.arange(calls, device=device)
        # (values, sample index, end of the half the index must lie in)
        for vals, idx, end in ((a[0], 2 * j, P), (c[0], 2 * j + 1, P),
                               (a[1], P + 2 * j, L), (c[1], P + 2 * j + 1, L)):
            ok = idx < end
            pn[:, idx[ok]] = vals[:, ok]
        out["pn"] = pn
    out["u"] = uniform01(_pairs(seed, B, 3, 1, device)[0][:, 0])
    return out


def frames(draws: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    """``noisy`` and ``clean`` ``[B, L, 2]`` (I/Q, jointly max-normalised per
    frame) and ``snr`` ``[B]`` from the draws, float64 on their device.
    ``cfg``: ``snr_db`` ``[min, max]``, ``nonlinear`` and, when it is true,
    ``pa_saturation``, ``pa_smoothness``, ``iq_amplitude_db``,
    ``iq_phase_deg``, ``phase_noise_dbchz`` and ``sample_rate``."""
    d = {k: v.to(F64) for k, v in draws.items()}
    L = d["zr"].shape[1]
    clean = torch.fft.ifft(torch.complex(d["zr"], d["zi"]), dim=1) * (L / math.sqrt(2.0 * L))
    x = clean
    if cfg["nonlinear"]:
        p = float(cfg["pa_smoothness"])
        a2 = x.abs() ** 2 / float(cfg["pa_saturation"]) ** 2
        g = x * (1.0 + a2 ** p) ** (-1.0 / (2.0 * p))
        phi = math.radians(float(cfg["iq_phase_deg"]))
        gain = 10.0 ** (float(cfg["iq_amplitude_db"]) / 20.0)
        q = gain * (math.cos(phi) * g.imag + math.sin(phi) * g.real)
        sigma_pn = math.sqrt(10.0 ** (float(cfg["phase_noise_dbchz"]) / 10.0)
                             * float(cfg["sample_rate"]))
        theta = torch.cumsum(sigma_pn * d["pn"], dim=1)
        x = torch.complex(g.real, q) * torch.polar(torch.ones_like(theta), theta)
    lo, hi = (float(v) for v in cfg["snr_db"])
    snr = lo + (hi - lo) * d["u"]
    power = torch.mean(x.abs() ** 2, dim=1, keepdim=True)
    sigma = torch.sqrt(power * 10.0 ** (-snr[:, None] / 10.0) / 2.0)
    noisy = x + sigma * torch.complex(d["nr"], d["ni"])
    m = torch.amax(torch.stack([noisy.real, noisy.imag, clean.real, clean.imag]).abs(),
                   dim=(0, 2)).clamp_min(1e-12)[:, None]
    return {"noisy": torch.stack([noisy.real / m, noisy.imag / m], dim=-1),
            "clean": torch.stack([clean.real / m, clean.imag / m], dim=-1),
            "snr": snr}
