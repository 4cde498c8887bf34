"""Distributional realism: does the adversarial term buy distribution
matching? (counterpart of ``ofdmgan_tpu/eval/distributional.py:43-146``).

Three measures of enhanced frames against clean frames:

* **PSD match**: the mean absolute dB gap between their average
  periodograms;
* **amplitude moments**: mean, std, skew and excess kurtosis of ``|I + jQ|``
  (population statistics, as ``jnp.std``'s);
* **MMD^2**: the unbiased Gaussian-kernel maximum mean discrepancy between
  the two frame sets (frames as flat ``2L`` vectors, the bandwidth by the
  median heuristic on the clean set), with a null floor: the MMD^2 of the
  clean set against an independent clean draw.

``make_report_fn`` streams paired batches through the enhancer and keeps
the same statistics as the reference's ``lax.scan``: per-batch
periodograms (dB) and moments averaged over the batches, and the first
``min(mmd_samples // n_batches + 1, batch_size)`` frames of each batch for
the MMD pass. Kernel matrices stay float32 (TF32 is off, ``device.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..signal.datagen import DatagenConfig, make_draws, synthetic_batch_from_draws
from .benchmark import seed_of

NULL_STREAM = 777   # the null floor's independent stream, as the reference's fold_in


def periodogram_db(frames: torch.Tensor) -> torch.Tensor:
    """Mean periodogram of I/Q frames ``[B, L, 2]`` -> ``[L]`` in dB."""
    x = torch.complex(frames[..., 0], frames[..., 1])
    psd = (torch.fft.fft(x, dim=-1).abs() ** 2).mean(dim=0)
    return 10.0 * torch.log10(psd + 1e-12)


def psd_distance_db(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Mean |dB gap| between average periodograms."""
    return (periodogram_db(est) - periodogram_db(ref)).abs().mean()


def amplitude_moments(frames: torch.Tensor) -> torch.Tensor:
    """``[mean, std, skew, excess kurtosis]`` of the ``|I + jQ|`` amplitude."""
    a = torch.complex(frames[..., 0], frames[..., 1]).abs().reshape(-1)
    mu = a.mean()
    sd = a.std(correction=0) + 1e-12
    z = (a - mu) / sd
    return torch.stack([mu, sd, (z ** 3).mean(), (z ** 4).mean() - 3.0])


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a ** 2).sum(-1)[:, None] + (b ** 2).sum(-1)[None, :] - 2.0 * a @ b.T


def mmd2_unbiased(x: torch.Tensor, y: torch.Tensor, bandwidth: torch.Tensor) -> torch.Tensor:
    """Unbiased MMD^2 with a Gaussian RBF kernel; ``x`` ``[m, d]``, ``y``
    ``[n, d]``, O(m n) memory."""
    def k(a, b):
        return torch.exp(-_sq_dists(a, b) / (2.0 * bandwidth ** 2))

    m, n = x.shape[0], y.shape[0]
    kxx, kyy, kxy = k(x, x), k(y, y), k(x, y)
    sum_xx = (kxx.sum() - torch.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - torch.trace(kyy)) / (n * (n - 1))
    return sum_xx + sum_yy - 2.0 * kxy.mean()


def median_bandwidth(x: torch.Tensor) -> torch.Tensor:
    """The median pairwise distance of ``x`` ``[m, d]`` (the median
    heuristic); of an even count, the mean of the two middle values, as
    ``jnp.median``'s (``torch.median`` returns the lower one)."""
    m = x.shape[0]
    iu = torch.triu_indices(m, m, offset=1, device=x.device)
    d2 = _sq_dists(x, x)[iu[0], iu[1]].clamp_min(0.0)
    s = torch.sort(d2).values
    n = s.numel()
    med = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0
    return torch.sqrt(med + 1e-12)


DrawFn = Callable[[int], Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]


def seeded_draws(seed: int, batch_size: int, dg_cfg: DatagenConfig,
                 device: torch.device) -> DrawFn:
    """``draw(i) -> (batch draws, null-floor draws)`` from two generators on
    ``device``: one for the paired batches, one for the independent clean
    draw of the null floor. Call it for i = 0, 1, ... in order."""
    gen = torch.Generator(device=device).manual_seed(seed_of(seed))
    null_gen = torch.Generator(device=device).manual_seed(seed_of(seed, NULL_STREAM))

    def draw(i: int):
        return (make_draws(gen, batch_size, dg_cfg.frame_length, dg_cfg.channel),
                make_draws(null_gen, batch_size, dg_cfg.frame_length, dg_cfg.channel))

    return draw


def make_report_fn(apply_fn: Callable[[torch.Tensor], torch.Tensor], dg_cfg: DatagenConfig,
                   batch_size: int = 512, n_batches: int = 64,
                   mmd_samples: int = 2048) -> Callable[[DrawFn], Dict[str, torch.Tensor]]:
    """``report(draw) -> metrics``: ``n_batches`` paired batches from
    ``draw(i)`` (``seeded_draws``, or injected draws) through ``apply_fn``
    (noisy frames -> enhanced; the identity measures the noisy
    distribution)."""
    frames_per_batch = min(mmd_samples // n_batches + 1, batch_size)

    @torch.no_grad()
    def report(draw: DrawFn) -> Dict[str, torch.Tensor]:
        psd_e, psd_c, mom_e, mom_c, se, sc, sc2, l1 = ([] for _ in range(8))
        for i in range(n_batches):
            draws, null_draws = draw(i)
            batch = synthetic_batch_from_draws(draws, dg_cfg)
            clean2 = synthetic_batch_from_draws(null_draws, dg_cfg)["clean"]
            est = apply_fn(batch["noisy"])
            clean = batch["clean"]
            psd_e.append(periodogram_db(est))
            psd_c.append(periodogram_db(clean))
            mom_e.append(amplitude_moments(est))
            mom_c.append(amplitude_moments(clean))
            se.append(est[:frames_per_batch].reshape(frames_per_batch, -1))
            sc.append(clean[:frames_per_batch].reshape(frames_per_batch, -1))
            sc2.append(clean2[:frames_per_batch].reshape(frames_per_batch, -1))
            l1.append((est - clean).abs().mean())
        se, sc, sc2 = (torch.cat(s)[:mmd_samples] for s in (se, sc, sc2))
        bw = median_bandwidth(sc[:min(2048, mmd_samples)])
        return {
            "psd_distance_db": (torch.stack(psd_e).mean(0) - torch.stack(psd_c).mean(0))
            .abs().mean(),
            "moments_est": torch.stack(mom_e).mean(0),
            "moments_clean": torch.stack(mom_c).mean(0),
            "mmd2": mmd2_unbiased(se, sc, bw),
            "mmd2_null": mmd2_unbiased(sc2, sc, bw),
            "bandwidth": bw,
            "paired_l1": torch.stack(l1).mean(),
        }

    return report
