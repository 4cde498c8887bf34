"""The PSD-overlay and amplitude-distribution figure of the
adversarial-value study: ``python -m ofdmgan_tpu_torch.distributional_figure``
(counterpart of the repository's ``scripts/distributional_figure.py``).

Left: the mean periodogram (dB) per FFT bin of the clean, noisy,
supervised, GAN and residual-GAN mini outputs on the nonlinear task (16,384
frames from the FFT datagen, seed 1234). Right: the per-sample amplitude
density. Colours: the Okabe-Ito set, one fixed colour per entity.

The models are the JAX package's committed checkpoints under ``results/``;
the port reads ``.npz`` files and checkpoint directories of the ``.npz``
layout, and skips a model kept only as an Orbax directory
(``scripts/extract_champion.py`` of the JAX package writes its ``.npz``).
``results/`` is not copied to the GPU's machine: run it with ``--device
cpu``. ``curves`` computes the plotted arrays without matplotlib.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

import numpy as np
import torch

COLORS = {"clean": "#000000", "noisy": "#999999", "supervised": "#0072B2",
          "GAN": "#D55E00", "residual GAN": "#009E73"}
MODELS = {
    "supervised": ("results/distributional_checkpoints/mini_sup_nl", False),
    "GAN": ("results/nonlinear_checkpoint", False),
    "residual GAN": ("results/residual_checkpoints/nonlinear/champion_params_g.npz", True),
}
AMPLITUDE_BINS = np.linspace(0, 1.0, 80)


def curves(frames: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """Each entity's mean periodogram ``[L]`` (dB) and amplitude density
    over ``AMPLITUDE_BINS`` (bin centres and values)."""
    from .eval.distributional import periodogram_db

    out = {}
    for label, x in frames.items():
        hist, edges = np.histogram(x.abs().flatten().cpu().numpy(), bins=AMPLITUDE_BINS,
                                   density=True)
        out[label] = {"psd_db": periodogram_db(x).cpu().numpy(),
                      "amplitude_centres": 0.5 * (edges[:-1] + edges[1:]),
                      "amplitude_density": hist}
    return out


def model_frames(noisy: torch.Tensor, root: Path, device) -> Dict[str, torch.Tensor]:
    """Each model's output on ``noisy``, for the models the port can read."""
    from .eval.loading import build_generator
    from .utils.params_io import load_params_tree

    out = {}
    for label, (path, residual) in MODELS.items():
        try:
            tree = load_params_tree(str(root / path))
        except FileNotFoundError as err:
            print(f"skip {label}: {err}", flush=True)
            continue
        gen = build_generator(tree, "mini", 16, residual=residual).to(device)
        with torch.no_grad():
            out[label] = gen(noisy)
    return out


def draw(c: Dict[str, Dict[str, np.ndarray]], out: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.2))
    for label, cv in c.items():
        ls, lw = ("--", 2.2) if label == "clean" else ("-", 1.8)
        ax1.plot(np.arange(len(cv["psd_db"])), cv["psd_db"], ls, color=COLORS[label], lw=lw,
                 label=label)
        ax2.plot(cv["amplitude_centres"], cv["amplitude_density"], ls, color=COLORS[label],
                 lw=lw, label=label)
    ax1.set_xlabel("FFT bin")
    ax1.set_ylabel("mean periodogram (dB)")
    ax1.set_title("PSD match (closer to clean = better)")
    ax1.grid(alpha=0.25, lw=0.5)
    ax1.legend(frameon=False, fontsize=9)
    ax2.set_xlabel("per-sample |I/Q| amplitude")
    ax2.set_ylabel("density")
    ax2.set_title("Amplitude distribution (regression-to-mean shows here)")
    ax2.grid(alpha=0.25, lw=0.5)
    fig.suptitle("Adversarial value, mini nonlinear task: what each training objective "
                 "does to the output distribution", fontsize=11)
    fig.tight_layout(rect=(0, 0, 1, 0.95))
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=150)
    plt.close(fig)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="PSD and amplitude figure of the mini models")
    ap.add_argument("--frames", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--root", default=".", help="the directory that holds results/")
    ap.add_argument("--out", default="build/distributional_psd_mini.png")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .device import resolve_device
    from .signal.datagen import DatagenConfig, synthetic_batch

    dev = resolve_device(args.device)
    cfg = DatagenConfig.make(frame_length=16, snr_range=(0, 30), nonlinear=True)
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(args.seed), args.frames, cfg)
    frames = {"clean": batch["clean"], "noisy": batch["noisy"],
              **model_frames(batch["noisy"], Path(args.root), dev)}
    c = curves(frames)
    draw(c, Path(args.out))
    print("wrote", args.out)
    return c


if __name__ == "__main__":
    main()
