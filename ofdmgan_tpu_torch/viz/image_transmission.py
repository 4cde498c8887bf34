"""Image transmission over OFDM and its figures, the joint source-channel
study (counterpart of ``ofdmgan_tpu/viz/image_transmission.py``).

``ImageOFDMSimulator`` sends an image as bits -> QAM -> OFDM -> channel ->
(optionally the trained generator over the received signal, frame by
frame) -> demodulation -> image, and scores it by PSNR, SSIM, NMSE and BER.
The channel's random numbers are split from its arithmetic, as in
``signal/channel.py``: ``make_draws(gen, n)`` draws them from a
``torch.Generator`` and ``transmit_from_draws`` / ``evaluate_from_draws``
run on given draws, so a test can hand both packages the same numbers and
the card and the CPU can run one draw set. The channel and the generator
run on ``device``; modulation and demodulation on the host.
The figure functions import matplotlib when they draw.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..eval.metrics import nmse as _nmse
from ..eval.metrics import psnr as _psnr
from ..eval.metrics import ssim_global as _ssim
from ..signal import channel as channel_lib
from ..signal import image_ofdm
from ..signal.channel import ChannelConfig
from ..utils.iq import complex_to_iq, iq_to_complex


@dataclasses.dataclass
class TransmissionResult:
    snr_db: float
    channel: str
    psnr_db: float
    ssim: float
    nmse: float
    ber: float
    enhanced_psnr_db: Optional[float] = None
    enhanced_ssim: Optional[float] = None


def patterns_3x3() -> Dict[str, np.ndarray]:
    """The simpleGAN 3x3 test patterns as 0..255 images."""
    circle = np.array([[1, 1, 1], [1, -1, 1], [1, 1, 1]], np.float32)
    cross = np.array([[-1, 1, -1], [1, 1, 1], [-1, 1, -1]], np.float32)
    return {k: ((v + 1) * 127.5).astype(np.uint8) for k, v in
            {"circle": circle, "cross": cross}.items()}


def builtin_test_image(size: int = 16) -> np.ndarray:
    """A deterministic grayscale test image (a gradient and a checkerboard):
    the study's own image, which needs no image file or Pillow."""
    y, x = np.mgrid[0:size, 0:size]
    return (x * 255 / (size - 1) * 0.5 + ((x // 4 + y // 4) % 2) * 127).astype(np.uint8)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


class ImageOFDMSimulator:
    """End-to-end image transmission with an optional generator
    (``[B, gen_frame, 2] -> [B, gen_frame, 2]``) run over the received
    signal in ``gen_frame`` chunks, each scaled to a peak of one."""

    def __init__(self, modulation: str = "QAM16", n_subcarriers: int = 64, cp_length: int = 16,
                 frame_length: int = 1024, channel_type: str = "awgn",
                 generator: Optional[torch.nn.Module] = None, gen_frame: int = 16,
                 device="cpu"):
        self.cfg = image_ofdm.ImageOFDMConfig(modulation, n_subcarriers, cp_length, frame_length)
        self.channel = ChannelConfig(channel_type)
        self.generator = generator
        self.gen_frame = gen_frame
        self.device = torch.device(device)

    def make_draws(self, gen: torch.Generator, n_samples: Optional[int] = None):
        """One transmission's channel draws from ``gen``: the noise ``nr``,
        ``ni`` ``[n_samples]`` (the frame length by default) and the fading
        draws of one frame."""
        n = n_samples or self.cfg.frame_length
        kw = dict(generator=gen, device=gen.device, dtype=torch.float32)
        return {"nr": torch.randn(n, **kw), "ni": torch.randn(n, **kw),
                **channel_lib.make_draws(gen, self.channel, ())}

    @torch.no_grad()
    def _enhance(self, iq: np.ndarray) -> np.ndarray:
        l, f = iq.shape[0], self.gen_frame
        x = np.pad(iq, ((0, (-l) % f), (0, 0))).reshape(-1, f, 2)
        m = np.maximum(np.abs(x).reshape(x.shape[0], -1).max(1)[:, None, None], 1e-9)
        y = self.generator(_t((x / m).astype(np.float32)).to(self.device)).cpu().numpy()
        return (y * m).reshape(-1, 2)[:l]

    def transmit_from_draws(self, image: np.ndarray, snr_db: float, draws: Dict,
                            enhance: bool = False):
        """(reconstructed image, received I/Q ``[L, 2]``, metadata)."""
        iq, meta = image_ofdm.image_to_ofdm(image, self.cfg)
        sig = iq_to_complex(_t(iq * meta["normalization_factor"])).to(self.device)
        draws = {k: v.to(self.device) for k, v in draws.items()}
        snr = torch.tensor(snr_db, dtype=torch.float32, device=self.device)
        rx, _ = channel_lib.apply(sig, snr, self.channel, draws)
        rx_iq = complex_to_iq(rx).cpu().numpy().astype(np.float32)
        if enhance and self.generator is not None:
            rx_iq = self._enhance(rx_iq)
        # the physical constellation scale is back before the channel
        recon = image_ofdm.ofdm_to_image(rx_iq, meta["original_shape"], self.cfg)
        return recon, rx_iq, meta

    def transmit(self, image: np.ndarray, snr_db: float, seed: int = 0, enhance: bool = False):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self.transmit_from_draws(image, snr_db, self.make_draws(gen), enhance)

    def evaluate_from_draws(self, image: np.ndarray, snr_values: List[float],
                            draws: List[Dict]) -> List[TransmissionResult]:
        """One result per SNR, from its draw set (the enhanced run reuses it)."""
        gray = image_ofdm.to_grayscale(image)
        bits_ref = np.unpackbits(gray.flatten())
        results = []
        for snr, d in zip(snr_values, draws):
            recon, _, _ = self.transmit_from_draws(image, snr, d)
            bits_rx = np.unpackbits(recon.astype(np.uint8).flatten())[: bits_ref.size]
            res = TransmissionResult(
                snr_db=float(snr), channel=self.channel.kind,
                psnr_db=float(_psnr(_t(recon), _t(gray))),
                ssim=float(_ssim(_t(recon), _t(gray))),
                nmse=float(_nmse(_t(recon.astype(np.float32)), _t(gray.astype(np.float32)))),
                ber=float(np.mean(bits_rx != bits_ref)))
            if self.generator is not None:
                recon_e, _, _ = self.transmit_from_draws(image, snr, d, enhance=True)
                res.enhanced_psnr_db = float(_psnr(_t(recon_e), _t(gray)))
                res.enhanced_ssim = float(_ssim(_t(recon_e), _t(gray)))
            results.append(res)
        return results

    def evaluate(self, image: np.ndarray, snr_values: List[float],
                 seed: int = 0) -> List[TransmissionResult]:
        """As ``evaluate_from_draws``, SNR ``i`` drawing from seed ``seed + i``."""
        draws = [self.make_draws(torch.Generator(device=self.device).manual_seed(seed + i))
                 for i in range(len(snr_values))]
        return self.evaluate_from_draws(image, snr_values, draws)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def generate_transmission_figures(output_dir: str = "docs/figures/ofdm_transmission",
                                  generator: Optional[torch.nn.Module] = None,
                                  snr_values=(0.0, 5.0, 10.0, 15.0, 20.0, 25.0),
                                  seed: int = 0, device="cpu") -> Dict:
    """The figures and the metrics JSON: transmissions over AWGN, Rayleigh
    and Rician, metric-against-SNR sweeps, the pipeline at 10 dB, the
    received constellation's density and the 3x3 patterns."""
    plt = _plt()
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    test_img = builtin_test_image()
    all_results: Dict[str, List[Dict]] = {}
    for ch in ("awgn", "rayleigh", "rician"):
        sim = ImageOFDMSimulator(channel_type=ch, generator=generator, device=device)
        all_results[ch] = [dataclasses.asdict(r)
                           for r in sim.evaluate(test_img, list(snr_values), seed)]

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ch, rows in all_results.items():
        snrs = [r["snr_db"] for r in rows]
        axes[0].plot(snrs, [r["psnr_db"] for r in rows], "o-", label=ch)
        axes[1].plot(snrs, [r["ssim"] for r in rows], "o-", label=ch)
        axes[2].semilogy(snrs, [max(r["ber"], 1e-6) for r in rows], "o-", label=ch)
    for ax, t in zip(axes, ("PSNR (dB)", "SSIM", "BER")):
        ax.set_xlabel("SNR (dB)")
        ax.set_title(t)
        ax.grid(alpha=0.3)
        ax.legend()
    fig.tight_layout()
    fig.savefig(out / "metrics_vs_snr.png", dpi=130)
    plt.close(fig)

    sim = ImageOFDMSimulator(channel_type="awgn", generator=generator, device=device)
    recon, rx_iq, _ = sim.transmit(test_img, 10.0, seed)
    cols = 3 if generator is not None else 2
    fig, axes = plt.subplots(1, cols, figsize=(3 * cols, 3.2))
    axes[0].imshow(image_ofdm.to_grayscale(test_img), cmap="gray")
    axes[0].set_title("original")
    axes[1].imshow(recon, cmap="gray")
    axes[1].set_title("received @10dB")
    if generator is not None:
        axes[2].imshow(sim.transmit(test_img, 10.0, seed, enhance=True)[0], cmap="gray")
        axes[2].set_title("GAN-enhanced")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out / "transmission_pipeline.png", dpi=130)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(4.2, 4))
    ax.hist2d(rx_iq[:, 0], rx_iq[:, 1], bins=60, cmap="viridis")
    ax.set_xlabel("I")
    ax.set_ylabel("Q")
    ax.set_title("received constellation density @10dB")
    fig.tight_layout()
    fig.savefig(out / "constellation_heatmap.png", dpi=130)
    plt.close(fig)

    pats = patterns_3x3()
    fig, axes = plt.subplots(2, len(pats) + 1, figsize=(3 * (len(pats) + 1), 6))
    sim_small = ImageOFDMSimulator(modulation="QPSK", n_subcarriers=8, cp_length=2,
                                   frame_length=64, channel_type="awgn", device=device)
    for j, (name, img) in enumerate(pats.items()):
        axes[0, j].imshow(img, cmap="gray", vmin=0, vmax=255)
        axes[0, j].set_title(f"{name} (tx)")
        axes[1, j].imshow(sim_small.transmit(img, 10.0, seed + j)[0], cmap="gray",
                          vmin=0, vmax=255)
        axes[1, j].set_title(f"{name} (rx @10dB)")
    axes[0, -1].axis("off")
    axes[1, -1].axis("off")
    for ax in axes.flat:
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out / "simplegan_patterns.png", dpi=130)
    plt.close(fig)

    (out / "transmission_metrics.json").write_text(json.dumps(all_results, indent=2))
    return all_results


def cross_pipeline_metrics(generator: Optional[torch.nn.Module] = None, gen_frame: int = 16,
                           snr_db: float = 10.0, channel_type: str = "rayleigh",
                           seed: int = 0, device="cpu", draws: Optional[Dict] = None) -> Dict:
    """The 3x3 cross through image -> QPSK -> OFDM -> channel, received
    noisy and enhanced: the images, the transmitted and received data
    symbols, and PSNR/SSIM/NMSE of each (``draws``, or seed ``seed``)."""
    from ..signal import ofdm, qam

    img = patterns_3x3()["cross"]
    sim = ImageOFDMSimulator(modulation="QPSK", n_subcarriers=8, cp_length=2, frame_length=64,
                             channel_type=channel_type, generator=generator,
                             gen_frame=gen_frame, device=device)
    if draws is None:
        draws = sim.make_draws(torch.Generator(device=sim.device).manual_seed(seed))
    recon_n, rx_iq_n, _ = sim.transmit_from_draws(img, snr_db, draws)
    if generator is not None:
        recon_e, rx_iq_e, _ = sim.transmit_from_draws(img, snr_db, draws, enhance=True)
    else:
        recon_e, rx_iq_e = recon_n, rx_iq_n
    spec = ofdm.OFDMSpec(sim.cfg.n_subcarriers, sim.cfg.cp_length)
    gray = image_ofdm.to_grayscale(img)
    tx_sym = qam.modulate(_t(np.unpackbits(gray.flatten())), "QPSK").numpy()

    def rx_symbols(iq):
        sym, _ = ofdm.demodulate(iq_to_complex(_t(iq)), spec)
        return sym.numpy()[: tx_sym.size]

    f32 = lambda a: _t(a.astype(np.float32))  # noqa: E731
    return {
        "gray": gray, "recon_noisy": recon_n, "recon_enhanced": recon_e, "tx_symbols": tx_sym,
        "rx_symbols_noisy": rx_symbols(rx_iq_n), "rx_symbols_enhanced": rx_symbols(rx_iq_e),
        "metrics": {
            "psnr_noisy": float(_psnr(_t(recon_n), _t(gray))),
            "psnr_enhanced": float(_psnr(_t(recon_e), _t(gray))),
            "ssim_noisy": float(_ssim(_t(recon_n), _t(gray))),
            "ssim_enhanced": float(_ssim(_t(recon_e), _t(gray))),
            "nmse_noisy": float(_nmse(f32(recon_n), f32(gray))),
            "nmse_enhanced": float(_nmse(f32(recon_e), f32(gray))),
        }}


def create_full_pipeline_cross_figure(
        output_path: str = "docs/figures/ofdm_transmission/full_pipeline_cross.png",
        generator: Optional[torch.nn.Module] = None, gen_frame: int = 16,
        snr_db: float = 10.0, channel_type: str = "rayleigh", seed: int = 0,
        device="cpu") -> Dict:
    """The transmission cross-section panel of ``cross_pipeline_metrics``:
    the original, noisy and enhanced images (pixel-annotated), the TX and RX
    constellations, their density heatmaps and a metrics box. Returns the
    metrics."""
    import matplotlib.gridspec as gridspec

    plt = _plt()
    c = cross_pipeline_metrics(generator, gen_frame, snr_db, channel_type, seed, device)
    m, tx_sym, have_gan = c["metrics"], c["tx_symbols"], generator is not None

    def annotate(ax, image):
        for i in range(image.shape[0]):
            for j in range(image.shape[1]):
                v = int(image[i, j])
                ax.text(j, i, str(v), ha="center", va="center", fontsize=7,
                        color="yellow" if v < 128 else "black")

    def constellation(ax, sym, color, title, ref=True):
        if ref:
            ax.scatter(tx_sym.real, tx_sym.imag, c="blue", s=40, alpha=0.3, marker="x")
        ax.scatter(sym.real, sym.imag, c=color, s=70, alpha=0.6, edgecolors="white",
                   linewidth=0.8)
        ax.axhline(0, color="gray", ls="--", lw=0.5)
        ax.axvline(0, color="gray", ls="--", lw=0.5)
        ax.set_xlabel("I")
        ax.set_ylabel("Q")
        ax.set_title(title, fontweight="bold", fontsize=10)
        ax.set_aspect("equal")
        ax.grid(alpha=0.3)

    def heatmap(ax, sym, title, cmap):
        r = max(1.5, float(np.abs(sym).max()) * 1.15)
        ax.hist2d(sym.real, sym.imag, bins=30, range=[[-r, r], [-r, r]], cmap=cmap)
        ax.axhline(0, color="white", lw=0.5, alpha=0.5)
        ax.axvline(0, color="white", lw=0.5, alpha=0.5)
        ax.set_xlabel("I")
        ax.set_ylabel("Q")
        ax.set_title(title, fontweight="bold", fontsize=10)
        ax.set_aspect("equal")

    def image_panel(cell, image, title):
        ax = fig.add_subplot(cell)
        ax.imshow(image, cmap="RdBu_r", vmin=0, vmax=255)
        ax.set_title(title, fontweight="bold", fontsize=10)
        ax.axis("off")
        annotate(ax, image)

    fig = plt.figure(figsize=(16, 10))
    gs = gridspec.GridSpec(3, 5, figure=fig)
    image_panel(gs[0, 0], c["gray"], "Original\n(Source Image)")
    constellation(fig.add_subplot(gs[0, 1]), tx_sym, "blue", "TX Symbols\n(Before Channel)",
                  ref=False)
    constellation(fig.add_subplot(gs[0, 2]), c["rx_symbols_noisy"], "red",
                  f"RX Symbols (Noisy)\n{channel_type}, SNR={snr_db:g} dB")
    constellation(fig.add_subplot(gs[0, 3]), c["rx_symbols_enhanced"], "green",
                  "RX Symbols\n(GAN Enhanced)" if have_gan else "RX Symbols\n(no enhancement)")
    ax = fig.add_subplot(gs[0, 4])
    ax.axis("off")
    txt = (f"Quality Metrics\n{'=' * 15}\n\nBefore GAN:\n{'-' * 13}\n"
           f"PSNR: {m['psnr_noisy']:.2f} dB\nSSIM: {m['ssim_noisy']:.4f}\n"
           f"NMSE: {m['nmse_noisy']:.4f}\n\nAfter GAN:\n{'-' * 13}\n"
           f"PSNR: {m['psnr_enhanced']:.2f} dB\nSSIM: {m['ssim_enhanced']:.4f}\n"
           f"NMSE: {m['nmse_enhanced']:.4f}\n\nImprovement:\n{'-' * 13}\n"
           f"dPSNR: {m['psnr_enhanced'] - m['psnr_noisy']:+.2f} dB\n"
           f"dSSIM: {m['ssim_enhanced'] - m['ssim_noisy']:+.4f}")
    ax.text(0.05, 0.95, txt, transform=ax.transAxes, fontsize=9, family="monospace",
            va="top", bbox=dict(boxstyle="round", facecolor="lightgray", alpha=0.8))
    image_panel(gs[1, 0], c["recon_noisy"], f"Noisy Recon\nPSNR: {m['psnr_noisy']:.1f} dB")
    image_panel(gs[2, 0], c["recon_enhanced"],
                f"Enhanced Recon\nPSNR: {m['psnr_enhanced']:.1f} dB")
    heatmap(fig.add_subplot(gs[1:, 1:3]), c["rx_symbols_noisy"],
            "Noisy Channel Constellation Density", "hot")
    heatmap(fig.add_subplot(gs[1:, 3:5]), c["rx_symbols_enhanced"],
            "GAN Enhanced Constellation Density" if have_gan
            else "Constellation Density (no enhancement)", "viridis")
    fig.suptitle(f"Image Transmission over OFDM Channel\n({channel_type.upper()}, "
                 f"SNR = {snr_db:g} dB)", fontsize=14, fontweight="bold", y=0.99)
    fig.tight_layout(rect=[0, 0, 1, 0.94])
    out = Path(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=150, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return m
