"""OFDM-like frame transform (counterpart of ``ofdmgan_tpu/signal/ofdm.py:104``).

The codec functions of the reference module (``modulate``, ``demodulate``,
``dft_matrices``) are not on the training path and are not ported yet.
"""

from __future__ import annotations

import math

import torch


def ofdm_like_frame(freq_symbols: torch.Tensor) -> torch.Tensor:
    """``ifft(freq) * sqrt(L)``: a unit-power time frame from unit-power
    frequency symbols (reference utils/dataset.py:241-247)."""
    n = freq_symbols.shape[-1]
    return torch.fft.ifft(freq_symbols, dim=-1) * math.sqrt(n)
