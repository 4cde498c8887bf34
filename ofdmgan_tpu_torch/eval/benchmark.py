"""The GAN-versus-classical equalizer benchmark: the SNR sweep (counterpart
of ``ofdmgan_tpu/eval/benchmark.py:36-324``).

Per SNR, ``n_trials`` frames at once:

* clean frames ``ifft(CN(0, 1) spectrum) * sqrt(L)``;
* optionally the nonlinear front end (Rapp PA, IQ imbalance, phase noise)
  before the channel;
* per-frame independent max-abs normalization of the noisy and the clean
  frame, or the training's joint normalization (``normalization``);
* the methods of ``METHODS``: the GAN, its quantized twin (GAN-Q: the mini
  generator's Q1.7/Q8.8 integer datapath, or a quantization-simulated
  forward such as the full U-Net's int8 export semantics), ZF, MMSE, the
  frame-wise Wiener shrinkage ``SNR / (1 + SNR) * Y`` (no access to the
  clean frame), DFE, LMS, RLS and no equalization;
* ``protocol``: ``"oracle"``, the reference's, where the classical
  equalizers see the clean data frame; or ``"pilot"``, where a known
  preamble precedes each data frame through the same front end and
  channel realization (so the phase noise's walk and the multipath's
  convolution carry from the preamble into the data frame), ZF and MMSE
  estimate H from the preamble and DFE, LMS and RLS adapt on it alone;
* MSE and EVM (dB) per trial, their means and standard deviations per SNR.

Randomness is split from the arithmetic: ``make_snr_draws`` draws every
random number of one SNR's batch from a ``torch.Generator`` and
``estimates_from_draws`` / ``snr_batch_from_draws`` are deterministic, so a
test can hand both packages the same numbers. The draws are ``zr``, ``zi``
(the spectra, ``[n, L]``), ``pn`` (phase-noise increments) and ``nr``,
``ni`` (the channel's noise), ``[n, L]`` or ``[n, 2L]`` under ``pilot``, the
fading channels' draws of ``channel.draw_shapes``, and under ``pilot`` the
preamble's spectrum ``pr``, ``pi`` (``[L]``). The reference's preamble is a
fixed JAX draw (``PRNGKey(2024)``), which needs JAX to reproduce; here its
default comes from a CPU ``torch.Generator`` seeded 2024
(``preamble_draws``), the same on every device, and the tests inject JAX's.
``run_benchmark`` seeds each SNR's generator apart, from ``(seed, i)``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..quant import intsim
from ..signal import channel as channel_lib
from ..signal import impairments as imp_lib
from ..signal.ofdm import ofdm_like_frame
from ..utils.iq import complex_to_iq, joint_max_normalize
from . import equalizers as eq
from .metrics import evm_db, mse

METHODS = ["GAN", "GAN-Q", "ZF", "MMSE", "Wiener", "DFE", "LMS", "RLS", "NoEQ"]
PREAMBLE_SEED = 2024
_EPS = 1e-10


def seed_of(*parts: int) -> int:
    """A generator seed from a tuple of integers (one stream per tuple)."""
    return int(np.random.SeedSequence(list(parts)).generate_state(1, np.uint64)[0] >> 1)


def device_of(generator, device=None) -> torch.device:
    """The device a sweep runs on: ``device`` if given, else the generator
    model's, else the GPU (``device.resolve_device``)."""
    if device is None and isinstance(generator, torch.nn.Module):
        device = next(generator.parameters()).device
    return resolve_device(device)


def _normalize_each(iq: torch.Tensor) -> torch.Tensor:
    """Independent per-frame max-abs normalization."""
    m = iq.abs().amax(dim=tuple(range(1, iq.ndim)), keepdim=True)
    return iq / m.clamp_min(1e-12)


def preamble_draws(frame_length: int) -> Dict[str, torch.Tensor]:
    """The fixed preamble's spectrum draws, from a CPU generator seeded
    ``PREAMBLE_SEED``."""
    gen = torch.Generator().manual_seed(PREAMBLE_SEED)
    return {k: torch.randn(frame_length, generator=gen) for k in ("pr", "pi")}


def make_snr_draws(gen: torch.Generator, n_trials: int, frame_length: int,
                   channel_type: str = "awgn", protocol: str = "oracle",
                   preamble: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Every random number of one SNR's batch, on ``gen``'s device."""
    if protocol not in ("oracle", "pilot"):
        raise ValueError(f"unknown protocol {protocol!r}")
    kw = dict(generator=gen, device=gen.device, dtype=torch.float32)
    tx_len = 2 * frame_length if protocol == "pilot" else frame_length
    draws = {k: torch.randn((n_trials, frame_length), **kw) for k in ("zr", "zi")}
    draws.update({k: torch.randn((n_trials, tx_len), **kw) for k in ("pn", "nr", "ni")})
    draws.update(channel_lib.make_draws(gen, channel_lib.ChannelConfig(channel_type),
                                        (n_trials,)))
    if protocol == "pilot":
        pre = preamble if preamble is not None else preamble_draws(frame_length)
        draws.update({k: pre[k].to(gen.device) for k in ("pr", "pi")})
    return draws


@torch.no_grad()
def estimates_from_draws(draws: Dict[str, torch.Tensor], snr_db: float,
                         channel_type: str = "awgn", nonlinear: bool = False,
                         pa_saturation: float = 1.0, generator: Optional[Callable] = None,
                         normalization: str = "independent", int_params=None,
                         int_mode: str = "rtl", protocol: str = "oracle",
                         gen_q: Optional[Callable] = None):
    """One SNR's batch from ``draws``: ``(clean_iq, {method: estimate})``,
    every frame ``[n, L, 2]`` on the draws' device. ``generator`` and
    ``gen_q`` map noisy frames to enhanced ones; ``int_params``
    (``intsim.quantize_weights_rtl``) runs GAN-Q on the integer datapath
    in ``int_mode``, else ``gen_q`` does."""
    if normalization not in ("independent", "joint"):
        raise ValueError(f"unknown normalization {normalization!r}")
    dev = draws["zr"].device
    snr = torch.tensor(snr_db, dtype=torch.float32, device=dev)
    L = draws["zr"].shape[-1]
    clean_c = ofdm_like_frame(torch.complex(draws["zr"], draws["zi"]) / math.sqrt(2.0))

    tx_p = None
    tx = clean_c
    if protocol == "pilot":
        pfreq = torch.complex(draws["pr"], draws["pi"]) / math.sqrt(2.0)
        tx_p = ofdm_like_frame(pfreq).expand_as(clean_c)
        tx = torch.cat([tx_p, clean_c], dim=-1)   # preamble ++ data
    distorted = tx
    if nonlinear:
        distorted = imp_lib.pa_rapp(distorted, pa_saturation, 3.0)
        distorted = imp_lib.iq_imbalance(distorted, 1.0, 5.0)
        distorted = imp_lib.phase_noise(distorted, draws["pn"], -80.0, 1e6)
    noisy_c, _ = channel_lib.apply(distorted, snr, channel_lib.ChannelConfig(channel_type),
                                   draws)
    rx_p = None
    if protocol == "pilot":
        rx_p, noisy_c = noisy_c[..., :L], noisy_c[..., L:]

    if normalization == "joint":
        noisy_iq, clean_iq = joint_max_normalize(complex_to_iq(noisy_c).float(),
                                                 complex_to_iq(clean_c).float())
    else:
        clean_iq = _normalize_each(complex_to_iq(clean_c).float())
        noisy_iq = _normalize_each(complex_to_iq(noisy_c).float())

    est = {}
    if generator is not None:
        est["GAN"] = generator(noisy_iq)
        if int_params is not None:
            est["GAN-Q"] = intsim.q88_to_float(intsim.generator_int_forward(
                int_params, intsim.float_to_q88(noisy_iq), int_mode))
        elif gen_q is not None:
            est["GAN-Q"] = gen_q(noisy_iq)
    est["NoEQ"] = noisy_iq
    snr_lin = 10.0 ** (snr / 10.0)
    est["Wiener"] = (snr_lin / (1.0 + snr_lin)) * noisy_iq

    if protocol == "pilot":
        def norm_iq(est_c):
            return _normalize_each(complex_to_iq(est_c).float())

        h_p = rx_p / (tx_p + _EPS)   # per-sample LS estimate from the preamble
        est["ZF"] = norm_iq(noisy_c / (h_p + _EPS))
        est["MMSE"] = norm_iq(torch.conj(h_p) / (h_p.abs() ** 2 + 1.0 / snr_lin) * noisy_c)
        est["DFE"] = norm_iq(eq.dfe_equalize(noisy_c, *eq.dfe_train(rx_p, tx_p)))
        est["LMS"] = norm_iq(eq.lms_equalize(noisy_c, eq.lms_train(rx_p, tx_p)[0]))
        est["RLS"] = norm_iq(eq.rls_equalize(noisy_c, eq.rls_train(rx_p, tx_p)[0]))
    else:
        est["ZF"] = eq.zf_equalize_iq(noisy_iq, clean_iq)[0]
        est["MMSE"] = eq.mmse_equalize_iq(noisy_iq, clean_iq, snr)[0]
        est["DFE"] = eq.dfe_equalize_iq(noisy_iq, clean_iq)[0]
        est["LMS"] = eq.lms_equalize_iq(noisy_iq, clean_iq)[0]
        est["RLS"] = eq.rls_equalize_iq(noisy_iq, clean_iq)[0]
    return clean_iq, est


def snr_batch_from_draws(draws: Dict[str, torch.Tensor], snr_db: float, **kw):
    """Per-method ``(mse [n], evm_db [n])`` of one SNR's batch
    (``estimates_from_draws``'s arguments)."""
    clean_iq, est = estimates_from_draws(draws, snr_db, **kw)
    return {m: (mse(e, clean_iq, per_item=True), evm_db(e, clean_iq, per_item=True))
            for m, e in est.items()}


def run_benchmark(
    generator: Optional[Callable],
    n_trials: int = 100,
    frame_length: int = 16,
    snr_values: Sequence[float] = (0, 5, 10, 15, 20, 25, 30),
    channel_type: str = "awgn",
    nonlinear: bool = False,
    pa_saturation: float = 1.0,
    seed: int = 0,
    normalization: str = "independent",
    include_quantized: bool = False,
    int_mode: str = "rtl",
    protocol: str = "oracle",
    gen_q: Optional[Callable] = None,
    device: str | torch.device | None = None,
) -> Dict[str, Dict[float, Dict[str, float]]]:
    """SNR sweep -> method -> snr -> ``{mse, mse_std, evm, evm_std}``.

    ``generator``: a model of the port (or ``None`` for the classical rows
    alone). With ``include_quantized`` the GAN-Q row runs ``gen_q`` if
    given, else the mini generator's integer datapath in ``int_mode``.
    Runs on ``device``: by default the generator's, or the GPU without one.
    """
    dev = device_of(generator, device)
    int_params = None
    if include_quantized and generator is not None and gen_q is None:
        int_params = intsim.quantize_weights_rtl(generator, "generator")
    have_q = int_params is not None or (include_quantized and gen_q is not None)
    methods = [m for m in METHODS
               if (generator is not None or m not in ("GAN", "GAN-Q"))
               and (have_q or m != "GAN-Q")]
    out: Dict[str, Dict[float, Dict[str, float]]] = {m: {} for m in methods}
    print(f"\nRunning benchmark: {n_trials} trials x {len(snr_values)} SNR values")
    print(f"Channel: {channel_type}, Non-linear: {nonlinear}")
    if nonlinear:
        print(f"  PA Saturation: {pa_saturation}, IQ Imbalance: 1.0dB/5deg")
    for i, snr in enumerate(snr_values):
        gen = torch.Generator(device=dev).manual_seed(seed_of(seed, i))
        draws = make_snr_draws(gen, n_trials, frame_length, channel_type, protocol)
        res = snr_batch_from_draws(
            draws, float(snr), channel_type=channel_type, nonlinear=nonlinear,
            pa_saturation=pa_saturation, generator=generator, normalization=normalization,
            int_params=int_params, int_mode=int_mode, protocol=protocol,
            gen_q=gen_q if include_quantized else None)
        for m in methods:
            ms, es = res[m][0].cpu().numpy(), res[m][1].cpu().numpy()
            out[m][snr] = {"mse": float(ms.mean()), "mse_std": float(ms.std()),
                           "evm": float(es.mean()), "evm_std": float(es.std())}
        print(f"  SNR = {snr} dB: done")
    return out


def print_results_table(results, snr_values, title: str = "") -> None:
    """MSE-in-dB table and the improvement summary."""
    methods = [m for m in ("GAN", "GAN-Q", "MMSE", "Wiener", "DFE", "RLS", "NoEQ")
               if m in results]
    print(f"\n{'=' * 80}\n  {title}\n{'=' * 80}")
    print(f"{'SNR (dB)':<10}" + "".join(f"{m:>12}" for m in methods))
    print("-" * 80)
    for snr in snr_values:
        row = f"{snr:<10.0f}"
        for m in methods:
            row += f"{10 * np.log10(results[m][snr]['mse'] + 1e-10):>12.2f}"
        print(row)
    print("-" * 80)
    high = max(snr_values)
    if "NoEQ" in results:
        print(f"\nImprovement over No Equalization at SNR={high}dB:")
        noeq = results["NoEQ"][high]["mse"]
        for m in methods:
            if m == "NoEQ":
                continue
            imp = 10 * np.log10(noeq / (results[m][high]["mse"] + 1e-10))
            print(f"  {m}: {imp:+.2f} dB")


def plot_benchmark_results(results, snr_values, title_suffix: str = "", save_path=None):
    """MSE and EVM against SNR (needs matplotlib, imported here)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    methods = [m for m in METHODS if m in results]
    colors = dict(zip(METHODS, ["red", "darkred", "blue", "green", "teal", "orange", "purple",
                                "brown", "gray"]))
    markers = dict(zip(METHODS, ["o", "h", "s", "^", "*", "v", "D", "p", "x"]))

    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    for ax, metric, ylabel in ((axes[0], "mse", "MSE (dB)"), (axes[1], "evm", "EVM (dB)")):
        for m in methods:
            vals = [results[m][s][metric] for s in snr_values]
            if metric == "mse":
                vals = [10 * np.log10(v + 1e-10) for v in vals]
            ax.plot(snr_values, vals, color=colors[m], marker=markers[m],
                    label=m, linewidth=2, markersize=8)
        ax.set_xlabel("SNR (dB)", fontsize=12)
        ax.set_ylabel(ylabel, fontsize=12)
        ax.set_title(f"{ylabel.split()[0]} vs SNR {title_suffix}", fontsize=14)
        ax.legend(loc="upper right")
        ax.grid(True, alpha=0.3)
        ax.set_xlim([min(snr_values), max(snr_values)])
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        print(f"Saved: {save_path}")
    plt.close(fig)
    return fig


def degradation_summary(results_linear, results_nonlinear, snr_values) -> List[tuple]:
    """Linear-against-nonlinear degradation table at the highest SNR."""
    high = max(snr_values)
    rows = []
    for m in ("GAN", "MMSE", "DFE", "RLS"):
        if m not in results_linear:
            continue
        lin = 10 * np.log10(results_linear[m][high]["mse"] + 1e-10)
        nl = 10 * np.log10(results_nonlinear[m][high]["mse"] + 1e-10)
        rows.append((m, lin, nl, nl - lin))
    print(f"\nAt SNR = {high} dB:")
    print("-" * 60)
    print(f"{'Method':<12} {'Linear MSE (dB)':<18} {'Non-Linear MSE (dB)':<18} {'Degradation'}")
    print("-" * 60)
    for m, lin, nl, d in rows:
        print(f"{m:<12} {lin:>16.2f}   {nl:>16.2f}   {d:>+8.2f} dB")
    print("-" * 60)
    return rows
