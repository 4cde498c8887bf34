"""Classical equalizer baselines: ZF, MMSE, DFE, LMS and RLS (counterpart of
``ofdmgan_tpu/eval/equalizers.py:38-255``).

Every function takes complex frames ``[..., N]`` with any leading (trial)
axes and treats each frame on its own: the batch takes the place of the
reference's ``vmap``, and each ``lax.scan`` is a loop over time on the
whole batch at once. The reference's quirks are kept, as its metrics
depend on them:

* ZF and MMSE estimate a per-sample "channel" ``H = received / clean``
  from the full frames (oracle-assisted).
* DFE and LMS filter with a plain product ``sum(w * x)`` (``jnp.dot``, no
  conjugate); RLS forms ``x^H P x`` and its a-priori output ``w^H x`` with
  conjugates (``jnp.vdot``) and equalizes with ``conj(w) . x``.
* The DFE's window is the received frame zero-padded by ``n_ff // 2``; its
  feedback register shifts in the training symbol while it adapts and its
  hard QPSK decision ``(sign(Re) + j sign(Im)) / sqrt(2)`` while it
  equalizes, with ``sign(0) = 0``.
* LMS and RLS adapt and equalize only ``[taps // 2, N - taps // 2)`` and
  write zeros at the edges (10 of 16 samples of a mini frame).

The ``*_equalize_iq`` functions take channels-last I/Q frames
``[..., L, 2]`` and return the equalized frames and per-frame metrics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..utils.iq import complex_to_iq, iq_to_complex

_EPS = 1e-10


# --------------------------------------------------------------------- linear
def zf_equalize(noisy_c: torch.Tensor, clean_c: torch.Tensor) -> torch.Tensor:
    """X = Y / H with H = Y / (X + eps)."""
    h = noisy_c / (clean_c + _EPS)
    return noisy_c / (h + _EPS)


def mmse_equalize(noisy_c: torch.Tensor, clean_c: torch.Tensor, snr_db) -> torch.Tensor:
    """X = conj(H) / (|H|^2 + 1/SNR) . Y; ``snr_db`` a number or a tensor
    that broadcasts against the frames' leading axes."""
    h = noisy_c / (clean_c + _EPS)
    snr_lin = 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32, device=h.device) / 10.0)
    return torch.conj(h) / (h.abs() ** 2 + 1.0 / snr_lin) * noisy_c


def _center(received: torch.Tensor, taps: int) -> torch.Tensor:
    """``taps`` weights with a unit centre tap, for every frame of ``received``."""
    w0 = torch.zeros(received.shape[:-1] + (taps,), dtype=torch.complex64,
                     device=received.device)
    w0[..., taps // 2] = 1.0
    return w0


def _shift_in(reg: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``[value, reg[:-1]]`` over the last axis."""
    return torch.cat([value[..., None], reg[..., :-1]], dim=-1)


# ------------------------------------------------------------------------ DFE
@dataclasses.dataclass(frozen=True)
class DFEConfig:
    n_ff: int = 5
    n_fb: int = 3
    mu: float = 0.01


def _pad(received: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` zeros on each side of the last axis."""
    z = torch.zeros(received.shape[:-1] + (n,), dtype=received.dtype, device=received.device)
    return torch.cat([z, received, z], dim=-1)


def dfe_train(received: torch.Tensor, training: torch.Tensor, cfg: DFEConfig = DFEConfig()):
    """LMS adaptation with the known symbols; returns ``(w_ff, w_fb)``."""
    n_ff, n_fb, mu = cfg.n_ff, cfg.n_fb, cfg.mu
    rp = _pad(received, n_ff // 2)
    w_ff = _center(received, n_ff)
    w_fb = torch.zeros(received.shape[:-1] + (n_fb,), dtype=torch.complex64,
                       device=received.device)
    fb = torch.zeros_like(w_fb)
    for n in range(training.shape[-1]):
        ff = rp[..., n:n + n_ff]
        y = (w_ff * ff).sum(-1) - (w_fb * fb).sum(-1)
        e = (training[..., n] - y)[..., None]
        w_ff = w_ff + mu * e * torch.conj(ff)
        w_fb = w_fb - mu * e * torch.conj(fb)
        fb = _shift_in(fb, training[..., n])
    return w_ff, w_fb


def dfe_equalize(received: torch.Tensor, w_ff: torch.Tensor, w_fb: torch.Tensor,
                 cfg: DFEConfig = DFEConfig()) -> torch.Tensor:
    """Decision-directed filtering of the whole frame."""
    rp = _pad(received, cfg.n_ff // 2)
    fb = torch.zeros_like(w_fb)
    out = []
    for n in range(received.shape[-1]):
        y = (w_ff * rp[..., n:n + cfg.n_ff]).sum(-1) - (w_fb * fb).sum(-1)
        dec = torch.complex(torch.sign(y.real), torch.sign(y.imag)) / math.sqrt(2.0)
        fb = _shift_in(fb, dec)
        out.append(y)
    return torch.stack(out, dim=-1)


# ------------------------------------------------------------------------ LMS
@dataclasses.dataclass(frozen=True)
class LMSConfig:
    n_taps: int = 11
    mu: float = 0.01


def lms_train(received: torch.Tensor, desired: torch.Tensor, cfg: LMSConfig = LMSConfig(),
              n_iterations: int = 1):
    """w <- w + mu e conj(x) over the centre region, ``n_iterations``
    passes; returns ``(weights, |e|^2 history [..., passes * positions])``."""
    t2, taps = cfg.n_taps // 2, cfg.n_taps
    w = _center(received, taps)
    errs = []
    for _ in range(n_iterations):
        for n in range(t2, received.shape[-1] - t2):
            x = received[..., n - t2:n - t2 + taps]
            e = desired[..., n] - (w * x).sum(-1)
            w = w + cfg.mu * e[..., None] * torch.conj(x)
            errs.append(e.abs() ** 2)
    return w, torch.stack(errs, dim=-1)


def _center_filter(received: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum(w * x)`` over each centre window, zeros at the edges."""
    t2, n = w.shape[-1] // 2, received.shape[-1]
    vals = (received.unfold(-1, w.shape[-1], 1) * w[..., None, :]).sum(-1)
    out = torch.zeros_like(received)
    out[..., t2:n - t2] = vals[..., :n - 2 * t2]
    return out


def lms_equalize(received: torch.Tensor, w: torch.Tensor,
                 cfg: LMSConfig = LMSConfig()) -> torch.Tensor:
    """Centre-region filtering, zeros at the edges."""
    return _center_filter(received, w)


# ------------------------------------------------------------------------ RLS
@dataclasses.dataclass(frozen=True)
class RLSConfig:
    n_taps: int = 11
    forgetting_factor: float = 0.99
    delta: float = 0.1


def rls_train(received: torch.Tensor, desired: torch.Tensor, cfg: RLSConfig = RLSConfig()):
    """The P-matrix recursion over the centre region; returns ``(weights,
    |e|^2 history)``."""
    t2, taps, lam = cfg.n_taps // 2, cfg.n_taps, cfg.forgetting_factor
    w = _center(received, taps)
    p = torch.eye(taps, dtype=torch.complex64, device=received.device) / cfg.delta
    p = p.expand(received.shape[:-1] + (taps, taps)).clone()
    errs = []
    for n in range(t2, received.shape[-1] - t2):
        x = received[..., n - t2:n - t2 + taps]
        px = (p @ x[..., None])[..., 0]
        k = px / (lam + (torch.conj(x) * px).sum(-1))[..., None]   # x^H P x
        e = desired[..., n] - (torch.conj(w) * x).sum(-1)          # w^H x
        w = w + k * torch.conj(e)[..., None]
        p = (p - (k[..., :, None] * torch.conj(x)[..., None, :]) @ p) / lam
        errs.append(e.abs() ** 2)
    return w, torch.stack(errs, dim=-1)


def rls_equalize(received: torch.Tensor, w: torch.Tensor,
                 cfg: RLSConfig = RLSConfig()) -> torch.Tensor:
    """y = conj(w) . x over the centre region, zeros at the edges."""
    return _center_filter(received, torch.conj(w))


# ------------------------------------------------------------- iq-level API
def _finish(eq_c: torch.Tensor, noisy_iq: torch.Tensor,
            clean_iq: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    eq_iq = complex_to_iq(eq_c).float()
    m = ((eq_iq - clean_iq) ** 2).mean(dim=(-2, -1))
    metrics = {"mse": m,
               "snr_improvement_db": 10.0 * torch.log10((noisy_iq ** 2).mean(dim=(-2, -1))
                                                        / (m + _EPS))}
    return eq_iq, metrics


def zf_equalize_iq(noisy_iq: torch.Tensor, clean_iq: torch.Tensor):
    """Channels-last frames ``[..., L, 2]`` -> (frames, per-frame metrics)."""
    eq = zf_equalize(iq_to_complex(noisy_iq), iq_to_complex(clean_iq))
    return _finish(eq, noisy_iq, clean_iq)


def mmse_equalize_iq(noisy_iq: torch.Tensor, clean_iq: torch.Tensor, snr_db=20.0):
    eq = mmse_equalize(iq_to_complex(noisy_iq), iq_to_complex(clean_iq), snr_db)
    return _finish(eq, noisy_iq, clean_iq)


def dfe_equalize_iq(noisy_iq: torch.Tensor, clean_iq: torch.Tensor,
                    cfg: DFEConfig = DFEConfig()):
    r, d = iq_to_complex(noisy_iq), iq_to_complex(clean_iq)
    w_ff, w_fb = dfe_train(r, d, cfg)
    return _finish(dfe_equalize(r, w_ff, w_fb, cfg), noisy_iq, clean_iq)


def lms_equalize_iq(noisy_iq: torch.Tensor, clean_iq: torch.Tensor,
                    cfg: LMSConfig = LMSConfig()):
    r, d = iq_to_complex(noisy_iq), iq_to_complex(clean_iq)
    w, errs = lms_train(r, d, cfg)
    eq_iq, metrics = _finish(lms_equalize(r, w, cfg), noisy_iq, clean_iq)
    metrics["convergence_mse"] = errs[..., -100:].mean(-1)   # all of them up to 100
    return eq_iq, metrics


def rls_equalize_iq(noisy_iq: torch.Tensor, clean_iq: torch.Tensor,
                    cfg: RLSConfig = RLSConfig()):
    r, d = iq_to_complex(noisy_iq), iq_to_complex(clean_iq)
    w, _ = rls_train(r, d, cfg)
    return _finish(rls_equalize(r, w, cfg), noisy_iq, clean_iq)


EQUALIZERS = {
    "ZF": zf_equalize_iq,
    "MMSE": mmse_equalize_iq,
    "DFE": dfe_equalize_iq,
    "LMS": lms_equalize_iq,
    "RLS": rls_equalize_iq,
}


def compare_equalizers(noisy_iq: torch.Tensor, clean_iq: torch.Tensor,
                       snr_db: float = 20.0) -> Dict[str, Dict[str, float]]:
    """All five on one frame ``[L, 2]``."""
    out = {}
    for name, fn in EQUALIZERS.items():
        _, m = fn(noisy_iq, clean_iq, snr_db) if name == "MMSE" else fn(noisy_iq, clean_iq)
        out[name] = {k: float(v) for k, v in m.items()}
    return out
