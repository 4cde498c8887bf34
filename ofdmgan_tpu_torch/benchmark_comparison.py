"""GAN against the classical equalizers:
``python -m ofdmgan_tpu_torch.benchmark_comparison`` (counterpart of the
repository's ``benchmark_comparison.py``, with its flags).

Runs two SNR sweeps, linear (the ``--channel``, AWGN by default) and with
the nonlinear impairments (``--nonlinear``: that one alone), prints the MSE
tables and the degradation summary, and saves the figures into
``--output_dir`` where matplotlib is installed (where it is not, it says
so in one line and writes none). ``--checkpoint`` is a checkpoint
directory of the port (its ``params_g.npz``) or a generator ``.npz``;
without one the generator is untrained. ``--quantized`` adds the GAN-Q
row: the mini generator's Q1.7/Q8.8 integer datapath in ``--int_mode``, or
the full U-Net under the int8 export's quantization (weights 8 bits,
activations 16). Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Benchmark GAN vs Classical Equalizers")
    parser.add_argument("--checkpoint", type=str, default="checkpoints/best_model",
                        help="checkpoint directory or generator .npz of a trained GAN")
    parser.add_argument("--n_trials", type=int, default=100)
    parser.add_argument("--model", choices=["mini", "full"], default="mini",
                        help="generator family: mini (258-param, 16-sample) or "
                             "full (3.94M-param 1024-sample U-Net)")
    parser.add_argument("--frame_length", type=int, default=None,
                        help="frame length (default 16 for mini, 1024 for full)")
    parser.add_argument("--snr_min", type=float, default=0)
    parser.add_argument("--snr_max", type=float, default=30)
    parser.add_argument("--snr_step", type=float, default=5)
    parser.add_argument("--channel", type=str, default="awgn",
                        choices=["awgn", "rayleigh", "rician", "multipath"])
    parser.add_argument("--nonlinear", action="store_true",
                        help="run ONLY the nonlinear sweep (default: both)")
    parser.add_argument("--pa_saturation", type=float, default=0.8)
    parser.add_argument("--qat", action="store_true",
                        help="the checkpoint was trained with --qat: evaluate the float rows "
                             "with the QAT forward")
    parser.add_argument("--rtl_qat", action="store_true",
                        help="the checkpoint was trained with --rtl_qat")
    parser.add_argument("--residual", action="store_true",
                        help="mini generator with the input-residual head (must match the "
                             "checkpoint's training head)")
    parser.add_argument("--quantized", action="store_true",
                        help="add a GAN-Q row: the fixed-point generator")
    parser.add_argument("--int_mode", choices=["rtl", "float_ref", "rtl_residual"],
                        default=None,
                        help="fixed-point semantics for GAN-Q (default: rtl, or rtl_residual "
                             "when --residual is set)")
    parser.add_argument("--normalization", choices=["independent", "joint"],
                        default="independent",
                        help="independent = the reference's protocol; joint = the training "
                             "protocol (shared noisy/clean scale)")
    parser.add_argument("--protocol", choices=["oracle", "pilot"], default="oracle",
                        help="oracle = equalizers see the clean data frame; pilot = "
                             "known-preamble channel estimation / tap adaptation only")
    parser.add_argument("--output_dir", type=str, default="./benchmark_results")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser


def main(argv=None):
    """Run the sweeps; returns ``(linear results or None, nonlinear results)``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    # a residual checkpoint deploys on the residual integer head; the
    # parameter tree is head-agnostic, so a wrong int_mode would evaluate
    # the wrong function
    if args.int_mode is None:
        args.int_mode = "rtl_residual" if args.residual else "rtl"
    elif args.residual and args.int_mode == "rtl":
        parser.error("--residual checkpoints deploy on the 'rtl_residual' integer "
                     "head; pass --int_mode rtl_residual (or float_ref) explicitly")
    if args.model == "full" and (args.qat or args.rtl_qat):
        parser.error("--qat/--rtl_qat apply to the mini (RTL-deployable) generator only")

    import numpy as np

    from .device import resolve_device
    from .eval.benchmark import (degradation_summary, plot_benchmark_results,
                                 print_results_table, run_benchmark)
    from .eval.loading import build_generator
    from .models import count_parameters
    from .utils.params_io import load_params_tree

    dev = resolve_device(args.device)
    print(f"Using device: {dev}")
    snr_values = [float(s) for s in np.arange(args.snr_min, args.snr_max + 1, args.snr_step)]
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if args.frame_length is None:
        args.frame_length = 1024 if args.model == "full" else 16

    tree = None
    kw = dict(residual=args.residual, qat=args.qat or args.rtl_qat, rtl_faithful=args.rtl_qat)
    try:
        if os.path.exists(args.checkpoint):
            print(f"Loading checkpoint: {args.checkpoint}")
            tree = load_params_tree(args.checkpoint)
        else:
            print("Warning: No checkpoint found, using untrained generator")
            print("Results will show potential, not actual trained performance")
        gen = build_generator(tree, args.model, args.frame_length, **kw).to(dev)
        gen_q = None
        if args.model == "full" and args.quantized:
            # the int8 per-channel / int16-activation export semantics in the
            # forward; the same parameters, so the float checkpoint evaluates
            gen_q = build_generator(tree, "full", args.frame_length,
                                    quant_bits=(8, 16)).to(dev)
    except (ValueError, FileNotFoundError) as err:
        parser.error(str(err))
    print(f"Generator parameters: {count_parameters(gen):,}")

    kw = dict(n_trials=args.n_trials, frame_length=args.frame_length, snr_values=snr_values,
              seed=args.seed, normalization=args.normalization,
              include_quantized=args.quantized, int_mode=args.int_mode,
              protocol=args.protocol, gen_q=gen_q, device=dev)
    plots = _have_matplotlib()
    if not plots:
        print(f"matplotlib is not installed: no figures written to {out}")

    results_lin = None
    if not args.nonlinear:
        print("\n" + "=" * 80 + "\n  BENCHMARK 1: Linear Channel (AWGN)\n" + "=" * 80)
        results_lin = run_benchmark(gen, channel_type=args.channel, nonlinear=False, **kw)
        print_results_table(results_lin, snr_values, "Linear AWGN Channel - MSE (dB)")
        if plots:
            plot_benchmark_results(results_lin, snr_values, "(Linear AWGN)",
                                   out / "benchmark_linear_awgn.png")

    print("\n" + "=" * 80 +
          "\n  BENCHMARK 2: Non-Linear Impairments (PA + IQ + Phase Noise)\n" + "=" * 80)
    results_nl = run_benchmark(gen, channel_type=args.channel, nonlinear=True,
                               pa_saturation=args.pa_saturation, **kw)
    print_results_table(results_nl, snr_values,
                        f"Non-Linear Impairments (PA sat={args.pa_saturation}) - MSE (dB)")
    if plots:
        plot_benchmark_results(results_nl, snr_values, f"(Non-Linear, PA={args.pa_saturation})",
                               out / "benchmark_nonlinear.png")

    if results_lin is not None:
        print("\n" + "=" * 80 + "\n  COMPARISON SUMMARY\n" + "=" * 80)
        degradation_summary(results_lin, results_nl, snr_values)
        print("\nKey Insight: Classical methods degrade significantly with non-linear")
        print("impairments. GAN shows more robust performance.")
    print(f"\nResults saved to: {out}")
    return results_lin, results_nl


if __name__ == "__main__":
    main()
