"""OFDM signal scenarios and their figures (counterpart of
``ofdmgan_tpu/viz/signal_viz.py``).

``OFDMSignalGenerator`` makes a clean 16-QAM OFDM frame and its
degradations (AWGN, a deep fade, burst interference, a frequency-selective
fade) from one numpy ``default_rng``, with the JAX package's draws in its
order, so both packages make the same arrays from a seed.
``research_scenarios`` lists the five scenarios of the research figures and
``scenario_rows`` enhances each through the port's ``MiniGenerator`` and
its integer datapath (``quant/intsim.py``, the RTL's operations): the rows
need no plotting package. ``OFDMVisualizer`` draws the panels and imports
matplotlib when it draws; ``create_research_quality_figures`` does both.
``verify/cosim_report.py`` takes its scenarios from here.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class OFDMSignal:
    """A named I/Q signal with its provenance."""

    name: str
    i: np.ndarray
    q: np.ndarray
    sample_rate: float = 1e6
    description: str = ""

    @property
    def complex(self) -> np.ndarray:
        return self.i + 1j * self.q

    @property
    def iq(self) -> np.ndarray:
        """``[L, 2]`` float32 I/Q."""
        return np.stack([self.i, self.q], -1).astype(np.float32)

    @property
    def power_db(self) -> float:
        return float(10 * np.log10(np.mean(self.i**2 + self.q**2) + 1e-12))


class OFDMSignalGenerator:
    """Clean 16-QAM OFDM frames and channel degradations, drawn from one
    ``numpy.random.default_rng(seed)``."""

    def __init__(self, n_subcarriers: int = 8, cp_length: int = 2, frame_length: int = 16,
                 seed: int = 0):
        self.n = n_subcarriers
        self.cp = cp_length
        self.frame_length = frame_length
        self.rng = np.random.default_rng(seed)

    def clean_frame(self) -> OFDMSignal:
        levels = np.array([-3, -1, 1, 3]) / np.sqrt(10)
        sym = self.rng.choice(levels, self.n) + 1j * self.rng.choice(levels, self.n)
        time = np.fft.ifft(sym) * self.n
        sig = np.resize(np.concatenate([time[-self.cp:], time]), self.frame_length)
        sig = sig / (np.max(np.abs(sig)) + 1e-12)
        return OFDMSignal("clean", sig.real, sig.imag, description="16-QAM OFDM frame")

    def add_awgn(self, s: OFDMSignal, noise_percent: float = 30.0) -> OFDMSignal:
        amp = noise_percent / 100.0 * np.max(np.abs(s.complex))
        n = len(s.i)
        c = s.complex + amp * (self.rng.standard_normal(n)
                               + 1j * self.rng.standard_normal(n)) / np.sqrt(2)
        return OFDMSignal(f"awgn{noise_percent:.0f}", c.real, c.imag,
                          description=f"AWGN {noise_percent:.0f}% of peak")

    def add_deep_fade(self, s: OFDMSignal, fade_percent: float = 60.0,
                      start: int = 4, stop: int = 8) -> OFDMSignal:
        c = s.complex.copy()
        c[start:stop] *= 1.0 - fade_percent / 100.0
        return OFDMSignal(f"fade{fade_percent:.0f}", c.real, c.imag,
                          description=f"deep fade {fade_percent:.0f}% @ {start}-{stop}")

    def add_burst_interference(self, s: OFDMSignal, burst_amp: float = 0.8,
                               start: int = 8, stop: int = 12) -> OFDMSignal:
        c = s.complex.copy()
        rnd = self.rng.standard_normal(stop - start) + 1j * self.rng.standard_normal(stop - start)
        c[start:stop] += burst_amp * rnd / np.sqrt(2)
        return OFDMSignal("burst", c.real, c.imag,
                          description=f"burst interference @ {start}-{stop}")

    def add_frequency_selective_fade(self, s: OFDMSignal, depth: float = 0.5) -> OFDMSignal:
        spec = np.fft.fft(s.complex)
        taper = 1.0 - depth * np.abs(np.sin(np.linspace(0, np.pi, len(spec))))
        c = np.fft.ifft(spec * taper)
        return OFDMSignal("freqsel", c.real, c.imag,
                          description=f"frequency-selective fade depth {depth}")

    def scenarios(self, clean: OFDMSignal) -> List[Tuple[str, OFDMSignal]]:
        """The five degradations of the research figures and the cosim
        report, drawn in this order."""
        return [
            ("awgn_30", self.add_awgn(clean, 30.0)),
            ("deep_fade_60", self.add_deep_fade(self.add_awgn(clean, 10.0), 60.0)),
            ("burst", self.add_burst_interference(self.add_awgn(clean, 10.0))),
            ("freq_selective", self.add_frequency_selective_fade(self.add_awgn(clean, 10.0))),
            ("worst_case", self.add_deep_fade(self.add_awgn(clean, 50.0), 80.0)),
        ]


def research_scenarios(seed: int = 0, frame_length: int = 16
                       ) -> Tuple[OFDMSignal, List[Tuple[str, OFDMSignal]]]:
    """The clean frame and the five scenarios of the research figures."""
    g = OFDMSignalGenerator(frame_length=frame_length, seed=seed)
    clean = g.clean_frame()
    return clean, g.scenarios(clean)


@torch.no_grad()
def scenario_rows(generator: torch.nn.Module, clean: OFDMSignal,
                  scenarios: List[Tuple[str, OFDMSignal]], device=None) -> List[Dict]:
    """Each scenario's MSE against the clean frame, degraded, enhanced by
    ``generator`` in float and by its RTL integer datapath, on ``device``
    (the generator's unless given)."""
    from ..quant import intsim

    device = device or next(generator.parameters()).device
    ip = intsim.quantize_weights_rtl(generator, "generator")
    ref = clean.iq[None]
    rows = []
    for name, s in scenarios:
        degraded = s.iq[None]                                           # [1, L, 2]
        x = torch.from_numpy(degraded).to(device)
        enh_f = generator(x).cpu().numpy()
        enh_i = intsim.q88_to_float(intsim.generator_int_forward(
            ip, intsim.float_to_q88(x), "rtl")).cpu().numpy()
        mse_before = float(np.mean((degraded - ref) ** 2))
        rows.append({
            "scenario": name,
            "description": s.description,
            "mse_degraded": mse_before,
            "mse_enhanced_float": float(np.mean((enh_f - ref) ** 2)),
            "mse_enhanced_int": float(np.mean((enh_i - ref) ** 2)),
            "snr_degraded_db": float(10 * np.log10(np.mean(ref**2) / (mse_before + 1e-12))),
        })
    return rows


class OFDMVisualizer:
    """Multi-panel signal figures (matplotlib, imported when drawing)."""

    def __init__(self, output_dir: str = "docs/figures/signals"):
        self.out = Path(output_dir)
        self.out.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def _plt():
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt

    def _save(self, plt, fig, fname: str) -> Path:
        fig.tight_layout()
        fig.savefig(self.out / fname, dpi=130)
        plt.close(fig)
        return self.out / fname

    def plot_time_domain(self, signals: List[OFDMSignal], fname: str = "time_domain.png"):
        plt = self._plt()
        fig, axes = plt.subplots(len(signals), 1, figsize=(10, 2.2 * len(signals)), sharex=True,
                                 squeeze=False)
        for ax, s in zip(axes[:, 0], signals):
            ax.plot(s.i, "b.-", label="I", ms=4)
            ax.plot(s.q, "r.-", label="Q", ms=4)
            ax.set_ylabel(s.name, fontsize=9)
            ax.grid(alpha=0.3)
            ax.legend(loc="upper right", fontsize=7)
        axes[-1, 0].set_xlabel("sample")
        fig.suptitle("Time-domain I/Q")
        return self._save(plt, fig, fname)

    def plot_constellation(self, signals: List[OFDMSignal], fname: str = "constellation.png"):
        plt = self._plt()
        fig, axes = plt.subplots(1, len(signals), figsize=(3.2 * len(signals), 3.2),
                                 squeeze=False)
        for ax, s in zip(axes[0], signals):
            ax.scatter(s.i, s.q, s=18, alpha=0.7)
            ax.set_title(s.name, fontsize=9)
            ax.set_xlabel("I")
            ax.set_ylabel("Q")
            ax.grid(alpha=0.3)
            ax.axhline(0, color="gray", lw=0.5)
            ax.axvline(0, color="gray", lw=0.5)
        fig.suptitle("Constellations")
        return self._save(plt, fig, fname)

    def plot_psd(self, signals: List[OFDMSignal], fname: str = "psd.png"):
        plt = self._plt()
        fig, ax = plt.subplots(figsize=(8, 4))
        for s in signals:
            spec = np.fft.fftshift(np.fft.fft(s.complex))
            f = np.fft.fftshift(np.fft.fftfreq(len(spec), 1 / s.sample_rate)) / 1e3
            ax.plot(f, 20 * np.log10(np.abs(spec) + 1e-9), label=s.name)
        ax.set_xlabel("frequency (kHz)")
        ax.set_ylabel("PSD (dB)")
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
        return self._save(plt, fig, fname)

    def plot_spectrogram(self, signals: List[OFDMSignal], fname: str = "spectrogram.png",
                         nperseg: int = 8, overlap: float = 0.5):
        """A Hann-window STFT panel per signal (8-sample windows: a 2 x 5
        grid of bins for a 16-sample frame)."""
        plt = self._plt()
        nperseg = min(nperseg, min(len(s.i) for s in signals))
        hop = max(1, int(nperseg * (1 - overlap)))
        win = np.hanning(nperseg)
        fig, axes = plt.subplots(1, len(signals), figsize=(3.2 * len(signals), 3.2),
                                 squeeze=False)
        for ax, s in zip(axes[0], signals):
            x = s.complex
            starts = range(0, len(x) - nperseg + 1, hop)
            stft = np.stack([np.fft.fftshift(np.fft.fft(win * x[i:i + nperseg]))
                             for i in starts], axis=1)
            t_ms = (np.asarray(list(starts)) + nperseg / 2) / s.sample_rate * 1e3
            f_khz = np.fft.fftshift(np.fft.fftfreq(nperseg, 1 / s.sample_rate)) / 1e3
            im = ax.pcolormesh(t_ms, f_khz, 20 * np.log10(np.abs(stft) + 1e-9),
                               shading="auto", cmap="viridis")
            ax.set_title(s.name, fontsize=9)
            ax.set_xlabel("time (ms)")
            ax.set_ylabel("frequency (kHz)")
            fig.colorbar(im, ax=ax, label="dB")
        return self._save(plt, fig, fname)

    def metric_table(self, rows: List[Dict], fname: str = "metrics.json"):
        (self.out / fname).write_text(json.dumps(rows, indent=2))
        return self.out / fname


def create_research_quality_figures(generator: Optional[torch.nn.Module] = None,
                                    output_dir: str = "docs/figures/signals",
                                    seed: int = 0) -> Dict[str, List[Dict]]:
    """The scenario figures and the enhancement table through ``generator``
    (a ``MiniGenerator`` initialised from torch seed 0 when none is given),
    on the generator's device; writes ``scenario_results.json``."""
    from ..models import MiniGenerator

    clean, scenarios = research_scenarios(seed)
    viz = OFDMVisualizer(output_dir)
    signals = [clean] + [s for _, s in scenarios]
    viz.plot_time_domain(signals)
    viz.plot_constellation(signals)
    viz.plot_psd(signals)
    viz.plot_spectrogram(signals)
    if generator is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            generator = MiniGenerator()
    rows = scenario_rows(generator, clean, scenarios)
    viz.metric_table(rows, "scenario_results.json")
    return {"scenarios": rows}
