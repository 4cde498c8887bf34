"""Signal-quality metrics: MSE, EVM, SNR improvement, BER, PSNR, NMSE and
global SSIM (counterpart of ``ofdmgan_tpu/eval/metrics.py:18-74``).

Each reduces over every axis, or over all but the leading one with
``per_item``. Variances are population variances (``correction=0``), as
``jnp.var``'s.
"""

from __future__ import annotations

import torch


def _mean(x: torch.Tensor, per_item: bool) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim))) if per_item else x.mean()


def mse(est: torch.Tensor, ref: torch.Tensor, per_item: bool = False) -> torch.Tensor:
    return _mean((est - ref).abs() ** 2, per_item)


def mse_db(est: torch.Tensor, ref: torch.Tensor, per_item: bool = False) -> torch.Tensor:
    return 10.0 * torch.log10(mse(est, ref, per_item) + 1e-10)


def _evm_ratio(est: torch.Tensor, ref: torch.Tensor, per_item: bool) -> torch.Tensor:
    return torch.sqrt(_mean((est - ref).abs() ** 2, per_item) / _mean(ref.abs() ** 2, per_item))


def evm_db(est: torch.Tensor, ref: torch.Tensor, per_item: bool = False) -> torch.Tensor:
    """20 log10(sqrt(E|err|^2 / E|ref|^2))."""
    return 20.0 * torch.log10(_evm_ratio(est, ref, per_item) + 1e-10)


def evm_percent(est: torch.Tensor, ref: torch.Tensor, per_item: bool = False) -> torch.Tensor:
    return 100.0 * _evm_ratio(est, ref, per_item)


def snr_improvement_db(noisy: torch.Tensor, est: torch.Tensor, ref: torch.Tensor,
                       per_item: bool = False) -> torch.Tensor:
    """10 log10(P_noisy / MSE(est))."""
    return 10.0 * torch.log10(_mean(noisy ** 2, per_item) / (mse(est, ref, per_item) + 1e-10))


def ber(bits_est: torch.Tensor, bits_ref: torch.Tensor) -> torch.Tensor:
    return (bits_est != bits_ref).float().mean()


def psnr(est: torch.Tensor, ref: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    """Peak SNR of the image path."""
    m = ((est.float() - ref.float()) ** 2).mean()
    return 10.0 * torch.log10(max_val ** 2 / (m + 1e-10))


def nmse(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return ((est - ref).abs() ** 2).sum() / ((ref.abs() ** 2).sum() + 1e-10)


def ssim_global(est: torch.Tensor, ref: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    """Global (single-window) SSIM, as the reference computes it."""
    x, y = est.float(), ref.float()
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    mx, my = x.mean(), y.mean()
    vx, vy = x.var(correction=0), y.var(correction=0)
    cov = ((x - mx) * (y - my)).mean()
    return ((2 * mx * my + c1) * (2 * cov + c2)) / ((mx ** 2 + my ** 2 + c1) * (vx + vy + c2))
