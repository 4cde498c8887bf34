"""Distributional realism of generator checkpoints:
``python -m ofdmgan_tpu_torch.distributional_report`` (counterpart of the
repository's ``scripts/distributional_report.py``, with its flags and its
JSON layout).

Supervised training wins paired L1; does the adversarial term win
distribution matching? For the raw noisy frames and each checkpoint
(``label=path``: a checkpoint directory of the port or a generator
``.npz``) it measures the PSD match, the amplitude moments and the
unbiased MMD^2 with its clean-against-clean null floor
(``eval/distributional.py``), every row on the same seeded batches.
``--forward`` picks the full U-Net's deployed forward: the float module,
the serving forward (``serving``: fused decoder, bfloat16) or the int8
export's quantization (``int8``: weights 8 bits, activations 16).
``--json`` writes the rows. Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Distributional-realism comparison of checkpoints")
    ap.add_argument("--checkpoint", nargs="+", default=[],
                    help="label=path entries (checkpoint directory or .npz)")
    ap.add_argument("--model", choices=["mini", "full"], default="mini")
    ap.add_argument("--residual", action="store_true")
    ap.add_argument("--frame_length", type=int, default=None)
    ap.add_argument("--nonlinear", action="store_true")
    ap.add_argument("--channel", type=str, default="awgn",
                    choices=["awgn", "rayleigh", "rician", "multipath"])
    ap.add_argument("--pa_saturation", type=float, default=0.8)
    ap.add_argument("--batch_size", type=int, default=512)
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--mmd_samples", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--forward", default="module", choices=["module", "serving", "int8"],
                    help="which deployed forward evaluates the checkpoints (full model "
                         "only): the float module, the bf16 fused-decoder serving forward, "
                         "or the int8 per-channel weight + int16 activation simulation")
    return ap


def main(argv=None) -> dict:
    """Measure and print each row; returns the JSON document."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.forward != "module" and args.model != "full":
        ap.error("--forward serving/int8 applies to --model full")

    import torch

    from .device import resolve_device
    from .eval.distributional import make_report_fn, seeded_draws
    from .eval.loading import build_generator
    from .signal.datagen import DatagenConfig
    from .utils.params_io import load_params_tree

    dev = resolve_device(args.device)
    if args.frame_length is None:
        args.frame_length = 1024 if args.model == "full" else 16
    dg = DatagenConfig.make(frame_length=args.frame_length, snr_range=(0, 30),
                            nonlinear=args.nonlinear, channel_type=args.channel,
                            pa_saturation=args.pa_saturation)
    kw = dict(batch_size=args.batch_size, n_batches=args.batches, mmd_samples=args.mmd_samples)
    rows = {}

    def run(label, apply_fn):
        r = make_report_fn(apply_fn, dg, **kw)(seeded_draws(args.seed, args.batch_size, dg, dev))
        r = {k: v.cpu() for k, v in r.items()}
        me, mc = r["moments_est"].tolist(), r["moments_clean"].tolist()
        null = float(r["mmd2_null"])
        row = {
            "psd_distance_db": float(r["psd_distance_db"]),
            "mmd2": float(r["mmd2"]),
            "mmd2_null_floor": null,
            "mmd2_over_null": float(r["mmd2"]) / max(1e-12, null),
            "paired_l1": float(r["paired_l1"]),
            "amp_moments_est": me,
            "amp_moments_clean": mc,
            "amp_std_ratio": me[1] / max(1e-12, mc[1]),
        }
        rows[label] = row
        print(f"{label:>24}: PSD Δ {row['psd_distance_db']:7.4f} dB | "
              f"MMD² {row['mmd2']:.3e} (null {row['mmd2_null_floor']:.3e}, "
              f"x{row['mmd2_over_null']:.1f}) | amp-std ratio "
              f"{row['amp_std_ratio']:.4f} | L1 {row['paired_l1']:.5f}", flush=True)

    def forward_of(tree):
        quant = (8, 16) if args.forward == "int8" else None
        gen = build_generator(tree, args.model, args.frame_length, residual=args.residual,
                              quant_bits=quant).to(dev)
        if args.forward == "serving":
            from .models.unet_infer import make_unet_infer_apply

            serve = make_unet_infer_apply(levels=gen.levels, act_dtype=torch.bfloat16)
            return lambda x: serve(gen, x).float()
        return gen

    run("noisy (no enhancement)", lambda x: x)
    for entry in args.checkpoint:
        label, _, path = entry.partition("=")
        if not path:
            label, path = Path(entry).stem, entry
        try:
            fwd = forward_of(load_params_tree(path))
        except (ValueError, FileNotFoundError) as err:
            ap.error(str(err))
        run(label, fwd)

    out = {"task": {"model": args.model, "frame_length": args.frame_length,
                    "nonlinear": args.nonlinear, "channel": args.channel,
                    "residual": args.residual, "forward": args.forward,
                    "frames": args.batches * args.batch_size,
                    "mmd_samples": args.mmd_samples, "seed": args.seed},
           "rows": rows}
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
        print(f"written: {args.json}")
    return out


if __name__ == "__main__":
    main()
