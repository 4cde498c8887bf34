"""Train the 3x3 simpleGAN: ``python -m ofdmgan_tpu_torch.simplegan.train_cli``
(counterpart of ``ofdmgan_tpu/simplegan/train_cli.py``, with its flags and
``--device``).

Trains with the MATLAB recipe on ``--device`` (the GPU unless ``cpu``),
exports the fixed-point text weights (``gen_*``/``disc_*.txt``) and, where
matplotlib is installed, saves ``generated_samples.png`` and
``loss_curve.png``: the .m script's outputs. The draws come from one CPU
``torch.Generator`` seeded ``--seed`` (the initial weights, then every
step's draws, then the sample latents) and are moved to the device, so a
run trains from the same numbers on every device.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train the 3x3 simpleGAN")
    parser.add_argument("--steps", type=int, default=30_000)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--dgl", type=int, default=2, help="D:G update ratio")
    parser.add_argument("--grad_mode", choices=["matlab", "exact"], default="matlab")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output_dir", type=str, default="./simplegan_output")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from ..device import resolve_device
    from . import (SimpleGANParams, export_weights_txt, generate_samples, init_params,
                   make_train_draws, pattern_score, train_from_draws)

    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    params = SimpleGANParams(*(t.to(dev) for t in init_params(gen)))
    params, losses = train_from_draws(params, **make_train_draws(gen, args.steps),
                                      eta_d=args.lr, eta_g=args.lr, dgl=args.dgl,
                                      grad_mode=args.grad_mode)
    ld, lg = losses["loss_d"].cpu().numpy(), losses["loss_g"].cpu().numpy()
    print(f"Trained {args.steps} steps on {dev} | final L_D={ld[-1]:.3f} L_G={lg[-1]:.3f}")
    print("Pattern scores:", pattern_score(params))

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    counts = export_weights_txt(params, str(out))
    print(f"Exported weights: {counts}")
    imgs = generate_samples(params, gen, 9).cpu().numpy()

    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: no figures written to {out}")
        return params, losses
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 3, figsize=(5, 5))
    for ax, img in zip(axes.flat, imgs):
        ax.imshow(img / 2 + 0.5, cmap="gray", vmin=0, vmax=1)
        ax.axis("off")
    fig.suptitle("Generated Samples (Trained simpleGAN)")
    fig.savefig(out / "generated_samples.png", dpi=130)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(ld, "r", lw=0.5, label="Discriminator Loss")
    ax.plot(lg, "b", lw=0.5, label="Generator Loss")
    ax.legend()
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.grid(alpha=0.3)
    ax.set_title("GAN Training Loss")
    fig.savefig(out / "loss_curve.png", dpi=130)
    plt.close(fig)
    print(f"Figures saved under {out}")
    return params, losses


if __name__ == "__main__":
    main()
