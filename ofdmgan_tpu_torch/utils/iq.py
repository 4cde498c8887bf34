"""I/Q layout conversions (counterpart of ``ofdmgan_tpu/utils/iq.py``).

Channels-last ``[..., L, 2]`` with ``[..., 0]`` = I (real) and ``[..., 1]`` =
Q (imag).
"""

from __future__ import annotations

import torch


def complex_to_iq(x: torch.Tensor) -> torch.Tensor:
    """Complex ``[..., L]`` -> real ``[..., L, 2]`` channels-last I/Q."""
    return torch.stack([x.real, x.imag], dim=-1)


def joint_max_normalize(noisy: torch.Tensor, clean: torch.Tensor, eps: float = 1e-12):
    """Scale each frame of a (noisy, clean) pair by one shared factor, the
    max of ``|noisy|`` and ``|clean|`` over all but the batch axis
    (reference ``utils/iq.py:34``)."""
    dims = tuple(range(1, noisy.ndim))
    m = torch.maximum(noisy.abs().amax(dim=dims, keepdim=True),
                      clean.abs().amax(dim=dims, keepdim=True))
    m = m.clamp_min(eps)
    return noisy / m, clean / m
