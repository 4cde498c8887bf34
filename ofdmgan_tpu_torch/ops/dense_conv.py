"""A micro conv1d as its dense (block-Toeplitz) matrix.

Counterpart of ``ofdmgan_tpu/ops/dense_conv.py:93``. A channels-last frame
``[L, C]`` flattens row-major to index ``t*C + c``; a zero-padded strided
conv1d is then ``y.flatten() = x.flatten() @ A``. The critic-gradient kernel
works on these matrices, ``dense_grads_to_params`` maps its gradients back
to the conv kernels through autograd of this expansion, and the flat mini
step (``models/flat.py``) trains through them. The matrix is built in the
reference's ``"onehot"`` form (``ofdmgan_tpu/ops/dense_conv.py:69-90``).
Its ``"dus"`` form (``:103-113``, the reference's default) builds the
same matrix bit for bit (its weight gradient sums the same terms in another
order); on a TPU the two differ in generated code, so the port keeps one
form, and the trainer's ``conv_expand`` is accepted and changes nothing.
The module also holds the U-Nets' nearest-neighbour upsample.
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
    holds the weights themselves, not sums of them. It is one broadcast
    multiply-reduce against the 0/1 placement tensor: elementwise, so exact
    under any matmul precision.
    """
    cout, cin, k = w.shape
    l_out = conv1d_output_length(l_in, k, stride, padding)
    blocks = w.permute(2, 1, 0)[:, None].expand(k, l_out, cin, cout)
    p = _placement(k, l_in, l_out, stride, padding, w.device)
    # [k,l_in,l_out,1,1] * [k,1,l_out,cin,cout] -> sum over k -> [l_in,l_out,cin,cout]
    a = (p[:, :, :, None, None] * blocks[:, None]).sum(0)
    return a.permute(0, 2, 1, 3).reshape(l_in * cin, l_out * cout)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample along the last axis: the length axis of
    a channels-first ``[..., C, L]`` activation (counterpart of
    ``ofdmgan_tpu/ops/dense_conv.py:194``, which repeats the length axis of a
    channels-last one)."""
    return x.repeat_interleave(2, dim=-1)
