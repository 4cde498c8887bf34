"""OFDM frame codec and the synthetic frame transform.

Counterpart of ``ofdmgan_tpu/signal/ofdm.py:24-112``: pilots at
``arange(0, N, pilot_spacing)`` with a constant value, time symbols
``ifft(freq) * N``, the last ``cp`` samples prepended as the cyclic prefix;
demodulation drops the prefix, takes ``fft / N`` and returns the data
subcarriers and the pilots' least-squares channel estimate.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OFDMSpec:
    n_subcarriers: int = 64
    cp_length: int = 16
    pilot_spacing: int = 8
    pilot_value: complex = 1 + 0j

    @property
    def samples_per_symbol(self) -> int:
        return self.n_subcarriers + self.cp_length

    @property
    def pilot_indices(self) -> np.ndarray:
        return np.arange(0, self.n_subcarriers, self.pilot_spacing)

    @property
    def data_indices(self) -> np.ndarray:
        mask = np.ones(self.n_subcarriers, dtype=bool)
        mask[self.pilot_indices] = False
        return np.nonzero(mask)[0]

    @property
    def n_data_subcarriers(self) -> int:
        return int(self.data_indices.size)


@lru_cache(maxsize=None)
def dft_matrices(n: int):
    """(Wr, Wi) float32 numpy, W[t, k] = exp(+j 2 pi t k / n): the
    unnormalised inverse DFT, ``ifft(x) * n == W @ x``."""
    t = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    w = np.exp(2j * np.pi * t * k / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def modulate(qam_symbols: torch.Tensor, spec: OFDMSpec) -> torch.Tensor:
    """QAM symbols ``[..., S]`` -> time signal ``[..., n_sym * (N + cp)]``:
    the stream zero-padded to whole OFDM symbols, data and pilots placed on
    their subcarriers, ``ifft * N``, the cyclic prefix prepended."""
    n, nd = spec.n_subcarriers, spec.n_data_subcarriers
    lead, s = qam_symbols.shape[:-1], qam_symbols.shape[-1]
    n_sym = -(-s // nd)
    padded = torch.zeros((*lead, n_sym * nd), dtype=torch.complex64, device=qam_symbols.device)
    padded[..., :s] = qam_symbols
    freq = torch.zeros((*lead, n_sym, n), dtype=torch.complex64, device=qam_symbols.device)
    freq[..., torch.from_numpy(spec.data_indices)] = padded.reshape(*lead, n_sym, nd)
    freq[..., torch.from_numpy(spec.pilot_indices)] = spec.pilot_value
    time = torch.fft.ifft(freq, dim=-1) * n
    with_cp = torch.cat([time[..., -spec.cp_length:], time], dim=-1)
    return with_cp.reshape(*lead, n_sym * spec.samples_per_symbol)


def demodulate(signal: torch.Tensor, spec: OFDMSpec):
    """Time signal ``[..., T]`` -> (data symbols ``[..., n_sym * Nd]``,
    pilot channel estimate ``[..., n_sym, n_pilots]``); a trailing partial
    symbol is dropped."""
    sps = spec.samples_per_symbol
    lead = signal.shape[:-1]
    n_sym = signal.shape[-1] // sps
    frames = signal[..., :n_sym * sps].reshape(*lead, n_sym, sps)
    freq = torch.fft.fft(frames[..., spec.cp_length:], dim=-1) / spec.n_subcarriers
    data = freq[..., torch.from_numpy(spec.data_indices)].reshape(*lead, -1)
    return data, freq[..., torch.from_numpy(spec.pilot_indices)] / spec.pilot_value


def ofdm_like_frame(freq_symbols: torch.Tensor) -> torch.Tensor:
    """``ifft(freq) * sqrt(L)``: a unit-power time frame from unit-power
    frequency symbols (reference utils/dataset.py:241-247)."""
    n = freq_symbols.shape[-1]
    return torch.fft.ifft(freq_symbols, dim=-1) * math.sqrt(n)
