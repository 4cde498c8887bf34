"""A micro conv1d as its dense (block-Toeplitz) matrix.

Counterpart of ``ofdmgan_tpu/ops/dense_conv.py:93``. A channels-last frame
``[L, C]`` flattens row-major to index ``t*C + c``; a zero-padded strided
conv1d is then ``y.flatten() = x.flatten() @ A``. The critic-gradient kernel
works on these matrices, and ``dense_grads_to_params`` maps its gradients
back to the conv kernels through autograd of this expansion.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def conv1d_output_length(l_in: int, kernel: int, stride: int, padding: int) -> int:
    return (l_in + 2 * padding - kernel) // stride + 1


@functools.lru_cache(maxsize=None)
def _placement(k: int, l_in: int, l_out: int, stride: int, padding: int,
               device: torch.device) -> torch.Tensor:
    """0/1 tensor ``P[k, t_in, t_out]``: tap ``k`` links ``t_in`` to ``t_out``.
    Kept per device: a copy from host memory would stall the stream each call."""
    p = np.zeros((k, l_in, l_out), np.float32)
    for t_out in range(l_out):
        for kk in range(k):
            t_in = stride * t_out - padding + kk
            if 0 <= t_in < l_in:
                p[kk, t_in, t_out] = 1.0
    return torch.from_numpy(p).to(device)


def conv1d_dense_matrix(w: torch.Tensor, l_in: int, stride: int, padding: int) -> torch.Tensor:
    """Torch conv weight ``[C_out, C_in, K]`` -> ``[L_in*C_in, L_out*C_out]``.

    Exactly one placement entry is non-zero per output cell, so the matrix
    holds the weights themselves, not sums of them.
    """
    cout, cin, k = w.shape
    l_out = conv1d_output_length(l_in, k, stride, padding)
    p = _placement(k, l_in, l_out, stride, padding, w.device)
    a = torch.einsum("oik,kab->aibo", w, p)
    return a.reshape(l_in * cin, l_out * cout)
