"""Philox4x32-10 and the Box-Muller transform, in plain PyTorch.

A frozen copy of the random numbers that the datagen kernel of the
PyTorch/CUDA port draws (its ``csrc/datagen.cu``): Random123's
Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011), a uniform on (0, 1) from the top 23 bits of a word, offset by
half a step, and Box-Muller on two such uniforms. The words are ``int64``
tensors that hold values below 2**32, and every product is split so that
it stays below 2**63: the integer arithmetic is exact on any device. The
normals are computed in float64.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """The high and low words of ``a * b`` (``a`` and each ``b`` below
    2**32), from two products below 2**48."""
    p_lo, p_hi = a * (b & 0xFFFF), a * (b >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & MASK


def philox4x32_10(ctr, key):
    """Philox4x32-10 of the counters ``ctr`` (four integers or ``int64``
    tensors that broadcast together, each word below 2**32) under ``key``
    (two words): the four output words as ``int64`` tensors."""
    dev = next((c.device for c in ctr if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev) for c in ctr))
    k0, k1 = int(key[0]) & MASK, int(key[1]) & MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
    return c0, c1, c2, c3


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """The (0, 1) uniform of a 32-bit word: its top 23 bits, offset by half
    a step, in float64 (exact)."""
    return (bits >> 9).to(torch.float64) * 2.0 ** -23 + 2.0 ** -24


def box_muller(b1: torch.Tensor, b2: torch.Tensor):
    """Two standard normals (float64) from two words: radius
    ``sqrt(-2 ln u1)``, angle ``2 pi u2``."""
    r = torch.sqrt(-2.0 * torch.log(uniform01(b1)))
    ang = 2.0 * torch.pi * uniform01(b2)
    return r * torch.cos(ang), r * torch.sin(ang)
