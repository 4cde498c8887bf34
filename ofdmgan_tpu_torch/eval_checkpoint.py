"""Rank generator checkpoints on a large fixed validation set:
``python -m ofdmgan_tpu_torch.eval_checkpoint`` (counterpart of the
repository's ``scripts/eval_checkpoint.py``, with its flags).

The trainer validates each epoch on about one batch, so a run's "best" is
noisy. This re-evaluates checkpoints (directories of the port or generator
``.npz`` files) on ``--batches`` seeded batches of ``--batch_size`` frames
(100 x 512 = 51,200 by default), drawn by the FFT datagen from one
generator seeded ``--seed``, the same batches for every checkpoint, and
prints the mean L1 with its standard error and the MSE of each, then all
of them as JSON. ``--identity`` adds the noisy input as a row; ``--ema``
evaluates a checkpoint directory's EMA generator. The forward: the float
model (``--residual`` for the mini residual head), the mini generator's
integer datapath (``--int_mode``), the full U-Net's serving forward
(``--serving``: the fused decoder with bfloat16 weights and activations) or
its quantization-simulated forward (``--quant_bits W A``). Each row also
gives its wall seconds. Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="High-sample validation of generator checkpoints")
    ap.add_argument("--checkpoint", nargs="+", default=[],
                    help="one or more checkpoint directories / .npz files")
    ap.add_argument("--identity", action="store_true",
                    help="also report the identity-map baseline (output = noisy input) on "
                         "the same paired batches")
    ap.add_argument("--ema", action="store_true",
                    help="evaluate the EMA generator of each checkpoint directory")
    ap.add_argument("--model", choices=["mini", "full"], default="mini")
    ap.add_argument("--residual", action="store_true",
                    help="build the mini generator with the input-residual head (must match "
                         "how the checkpoint was trained)")
    ap.add_argument("--int_mode", choices=["rtl", "float_ref", "rtl_residual"], default=None,
                    help="evaluate the Q1.7/Q8.8 integer datapath instead of the float model "
                         "(mini only)")
    ap.add_argument("--serving", action="store_true",
                    help="full model only: evaluate the serving forward (fused decoder, "
                         "bfloat16 weights and activations)")
    ap.add_argument("--quant_bits", type=int, nargs=2, default=None,
                    metavar=("WEIGHT_BITS", "ACT_BITS"),
                    help="full model only: evaluate the quantization-simulated forward, "
                         "e.g. --quant_bits 8 16")
    ap.add_argument("--frame_length", type=int, default=None)
    ap.add_argument("--nonlinear", action="store_true")
    ap.add_argument("--channel", type=str, default="awgn",
                    choices=["awgn", "rayleigh", "rician", "multipath"])
    ap.add_argument("--pa_saturation", type=float, default=0.8)
    ap.add_argument("--batch_size", type=int, default=512)
    ap.add_argument("--batches", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    """Evaluate; returns the printed results by row."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.residual and args.int_mode == "rtl":
        ap.error("--residual checkpoints deploy on the 'rtl_residual' integer head; pass "
                 "--int_mode rtl_residual (or float_ref)")
    if args.model == "full":
        if args.int_mode:
            ap.error("--int_mode applies to the mini (deployable) generator")
        if args.serving and args.quant_bits:
            ap.error("--serving is the full model's float serving path (quantized eval uses "
                     "--quant_bits)")
    else:
        if args.quant_bits:
            ap.error("--quant_bits applies to the full model (mini uses --int_mode for its "
                     "Q1.7/Q8.8 datapath)")
        if args.serving:
            ap.error("--serving is the full model's serving path (--model full)")

    import numpy as np
    import torch

    from .device import resolve_device
    from .eval.loading import build_generator
    from .signal.datagen import DatagenConfig, synthetic_batch
    from .utils.params_io import load_params_tree

    dev = resolve_device(args.device)
    if args.frame_length is None:
        args.frame_length = 1024 if args.model == "full" else 16
    dg = DatagenConfig.make(frame_length=args.frame_length, snr_range=(0, 30),
                            nonlinear=args.nonlinear, channel_type=args.channel,
                            pa_saturation=args.pa_saturation)
    n = args.batches

    def forward_of(tree):
        """noisy -> enhanced for the checkpoint ``tree``, on ``dev``."""
        gen = build_generator(tree, args.model, args.frame_length, residual=args.residual,
                              quant_bits=args.quant_bits).to(dev)
        if args.int_mode:
            from .quant import intsim

            ip = intsim.quantize_weights_rtl(gen, "generator")
            return lambda x: intsim.q88_to_float(intsim.generator_int_forward(
                ip, intsim.float_to_q88(x), args.int_mode))
        if args.serving:
            from .models.unet_infer import make_unet_infer_apply

            serve = make_unet_infer_apply(levels=gen.levels, act_dtype=torch.bfloat16)
            return lambda x: serve(gen, x).float()
        return gen

    @torch.no_grad()
    def sweep(name, apply_fn, weights):
        gen = torch.Generator(device=dev).manual_seed(args.seed)   # the same batches for all
        l1s, mses = [], []
        t0 = time.perf_counter()
        for _ in range(n):
            batch = synthetic_batch(gen, args.batch_size, dg)
            err = apply_fn(batch["noisy"]) - batch["clean"]
            l1s.append(err.abs().mean())
            mses.append((err ** 2).mean())
        l1s = torch.stack(l1s).cpu().numpy()
        mses = torch.stack(mses).cpu().numpy()
        seconds = time.perf_counter() - t0
        r = {"val_l1": float(np.mean(l1s)), "val_l1_sem": float(np.std(l1s) / math.sqrt(n)),
             "val_mse": float(np.mean(mses)), "frames": n * args.batch_size,
             "weights": weights, "seconds": seconds}
        print(f"{name}: val L1 {r['val_l1']:.5f} ± {r['val_l1_sem']:.5f} "
              f"MSE {r['val_mse']:.5f}  ({r['frames']} frames, {weights}, "
              f"{r['frames'] / seconds:,.0f} frames/s)", flush=True)
        return r

    results = {}
    if args.identity:
        results["identity"] = sweep("identity", lambda x: x, "—")
    for ck in args.checkpoint:
        try:
            fwd = forward_of(load_params_tree(ck, args.ema))
        except (ValueError, FileNotFoundError) as err:
            ap.error(str(err))
        results[ck] = sweep(ck, fwd, f"int:{args.int_mode}" if args.int_mode
                            else ("ema" if args.ema else "raw"))
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
