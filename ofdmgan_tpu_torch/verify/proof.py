"""The OFDM reconstruction proof, in float and through the integer datapath
(counterpart of ``ofdmgan_tpu/verify/proof.py``): QPSK-like +-0.7 frames
plus AWGN at one SNR -> generator -> MSE before and after, and the SNR
improvement in dB (reference proof/verification.py:331-384); the integer
variant runs the Q1.7/Q8.8 datapath (``quant/intsim.py``) on the device of
the frames, the RTL-equivalent accuracy table (tb_generator_mini.v:687-733).

Randomness is split from the arithmetic: ``make_proof_draws`` draws the
signs and the unit normal noise, and ``*_from_draws`` are deterministic,
so a test can hand both packages the same numbers. Both ``test_*``
functions keep the JAX package's names: import the module, not the names,
where pytest collects.

The means (the clean power and the MSEs) are summed in float64 and
rounded to float32, and the noise's scale and the dB are taken on the
host, so that they depend on no device's order of summation or division:
the clean power of the +-0.7 frames is then exact, the noisy frames equal
bit for bit on every device, and so do the integer datapath's MSEs. The JAX package sums in float32
(its clean power is 0.4899998 where the exact value is 0.48999998), so the
two agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..quant import intsim


def make_proof_draws(gen: torch.Generator, n_samples: int = 100,
                     frame_length: int = 16) -> Dict[str, torch.Tensor]:
    """``signs`` (bool, +0.7 where true) and ``noise`` (unit normal), both
    ``[n_samples, frame_length, 2]``, on ``gen``'s device."""
    shape = (n_samples, frame_length, 2)
    return {"signs": torch.rand(shape, generator=gen, device=gen.device) < 0.5,
            "noise": torch.randn(shape, generator=gen, device=gen.device)}


def _mean(x: torch.Tensor) -> torch.Tensor:
    """float32 mean, summed in float64 (independent of the summation order)."""
    return torch.mean(x, dtype=torch.float64).to(torch.float32)


def _frames(draws: Dict[str, torch.Tensor], snr_db: float, device: torch.device):
    signs, noise = draws["signs"].to(device), draws["noise"].to(device)
    clean = torch.where(signs, 0.7, -0.7).to(torch.float32)
    # the noise's scale on the host: a CUDA division by a scalar multiplies
    # by its reciprocal, an ulp from the CPU's quotient
    std = math.sqrt(float(_mean(clean ** 2)) / 10.0 ** (snr_db / 10.0))
    return clean, clean + std * noise


def _metrics(clean: torch.Tensor, noisy: torch.Tensor, enhanced: torch.Tensor,
             snr_db: float) -> Dict[str, float]:
    mse_before = float(_mean((noisy - clean) ** 2))
    mse_after = float(_mean((enhanced - clean) ** 2))
    return {"snr_input_db": float(snr_db), "mse_before": mse_before, "mse_after": mse_after,
            "snr_improvement_db": 10.0 * math.log10(mse_before / (mse_after + 1e-10))}


def signal_enhancement_from_draws(generator: torch.nn.Module, draws: Dict[str, torch.Tensor],
                                  snr_db: float) -> Dict[str, float]:
    """The float proof at ``snr_db`` on ``draws``, on the generator's device."""
    clean, noisy = _frames(draws, snr_db, next(generator.parameters()).device)
    with torch.no_grad():
        enhanced = generator(noisy)
    return _metrics(clean, noisy, enhanced, snr_db)


def int_datapath_enhancement_from_draws(generator: torch.nn.Module,
                                        draws: Dict[str, torch.Tensor], snr_db: float,
                                        mode: str = "rtl") -> Dict[str, float]:
    """The proof through the integer datapath in ``mode`` (``intsim``'s),
    on the generator's device: what fixed-point inference costs at
    ``snr_db``."""
    clean, noisy = _frames(draws, snr_db, next(generator.parameters()).device)
    ip = intsim.quantize_weights_rtl(generator, "generator")
    enhanced = intsim.q88_to_float(
        intsim.generator_int_forward(ip, intsim.float_to_q88(noisy), mode))
    return {"snr_input_db": float(snr_db), "mode": mode,
            **{k: v for k, v in _metrics(clean, noisy, enhanced, snr_db).items()
               if k != "snr_input_db"}}


def _draws(generator, n_samples, frame_length, gen):
    if gen is None:
        gen = torch.Generator(device=next(generator.parameters()).device).manual_seed(0)
    return make_proof_draws(gen, n_samples, frame_length)


def test_signal_enhancement(generator: torch.nn.Module, snr_db: float, n_samples: int = 100,
                            frame_length: int = 16,
                            gen: Optional[torch.Generator] = None) -> Dict[str, float]:
    """The float proof at one SNR on ``n_samples`` frames drawn from ``gen``
    (a generator seeded 0 on the model's device where none is given)."""
    return signal_enhancement_from_draws(
        generator, _draws(generator, n_samples, frame_length, gen), snr_db)


def test_int_datapath_enhancement(generator: torch.nn.Module, snr_db: float,
                                  n_samples: int = 100, frame_length: int = 16,
                                  mode: str = "rtl",
                                  gen: Optional[torch.Generator] = None) -> Dict[str, float]:
    """The integer-datapath proof at one SNR, drawn as ``test_signal_enhancement``."""
    return int_datapath_enhancement_from_draws(
        generator, _draws(generator, n_samples, frame_length, gen), snr_db, mode)
