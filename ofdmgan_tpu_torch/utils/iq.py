"""I/Q layout conversions (counterpart of ``ofdmgan_tpu/utils/iq.py``).

Channels-last ``[..., L, 2]`` with ``[..., 0]`` = I (real) and ``[..., 1]`` =
Q (imag).
"""

from __future__ import annotations

import torch


def complex_to_iq(x: torch.Tensor) -> torch.Tensor:
    """Complex ``[..., L]`` -> real ``[..., L, 2]`` channels-last I/Q."""
    return torch.stack([x.real, x.imag], dim=-1)


def iq_to_complex(x: torch.Tensor) -> torch.Tensor:
    """Real ``[..., L, 2]`` -> complex ``[..., L]``."""
    return torch.complex(x[..., 0], x[..., 1])


def nlc_to_ncl(x: torch.Tensor) -> torch.Tensor:
    """``[..., L, C]`` (this layout) -> ``[..., C, L]`` (the reference's)."""
    return x.transpose(-1, -2)


def ncl_to_nlc(x: torch.Tensor) -> torch.Tensor:
    """``[..., C, L]`` (the reference's layout) -> ``[..., L, C]``."""
    return x.transpose(-1, -2)


def joint_max_normalize(noisy: torch.Tensor, clean: torch.Tensor, eps: float = 1e-12):
    """Scale each frame of a (noisy, clean) pair by one shared factor, the
    max of ``|noisy|`` and ``|clean|`` over all but the batch axis
    (reference ``utils/iq.py:34``)."""
    dims = tuple(range(1, noisy.ndim))
    m = torch.maximum(noisy.abs().amax(dim=dims, keepdim=True),
                      clean.abs().amax(dim=dims, keepdim=True))
    m = m.clamp_min(eps)
    return noisy / m, clean / m
