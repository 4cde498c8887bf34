"""QAM modulation and hard-decision demodulation (QPSK, 16-QAM, 64-QAM).

Counterpart of ``ofdmgan_tpu/signal/qam.py``: the same constellations
(MSB-first bit-to-index map, a row-major PAM grid at unit average power) and
the same nearest-point demodulation, so bits and symbols agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def bits_per_symbol(modulation: str) -> int:
    mod = modulation.upper()
    if mod == "QPSK":
        return 2
    if mod == "QAM16":
        return 4
    if mod == "QAM64":
        return 6
    raise ValueError(f"Unsupported modulation: {modulation}")


def constellation(modulation: str) -> np.ndarray:
    """Points indexed by the MSB-first integer of a bit group: QPSK
    ``[1+1j, 1-1j, -1+1j, -1-1j]/sqrt(2)``; M-QAM the meshgrid of odd PAM
    levels, flattened row-major, over ``sqrt(2(M-1)/3)``."""
    mod = modulation.upper()
    if mod == "QPSK":
        return np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j], dtype=np.complex64) / np.sqrt(2)
    m = 2 ** bits_per_symbol(mod)
    sqrt_m = int(np.sqrt(m))
    levels = np.arange(-sqrt_m + 1, sqrt_m, 2)
    i_grid, q_grid = np.meshgrid(levels, levels)
    points = (i_grid + 1j * q_grid).flatten()
    return (points / np.sqrt(2.0 * (m - 1) / 3.0)).astype(np.complex64)


def modulate(bits: torch.Tensor, modulation: str) -> torch.Tensor:
    """Bits ``[..., n_bits]`` -> complex64 symbols ``[..., n_bits // b]``;
    trailing bits that fill no group are dropped."""
    b = bits_per_symbol(modulation)
    const = torch.from_numpy(constellation(modulation)).to(bits.device, torch.complex64)
    n_sym = bits.shape[-1] // b
    groups = bits[..., :n_sym * b].reshape(*bits.shape[:-1], n_sym, b).to(torch.int64)
    powers = torch.tensor(2 ** np.arange(b - 1, -1, -1), dtype=torch.int64, device=bits.device)
    return const[(groups * powers).sum(dim=-1)]


def demodulate(symbols: torch.Tensor, modulation: str) -> torch.Tensor:
    """Nearest constellation point, unpacked MSB-first: symbols ``[..., S]``
    -> int64 bits ``[..., S * b]``."""
    b = bits_per_symbol(modulation)
    const = torch.from_numpy(constellation(modulation)).to(symbols.device, torch.complex64)
    idx = ((symbols[..., None] - const).abs() ** 2).argmin(dim=-1)
    shifts = torch.arange(b - 1, -1, -1, device=symbols.device)
    bits = (idx[..., None] >> shifts) & 1
    return bits.reshape(*symbols.shape[:-1], symbols.shape[-1] * b)
