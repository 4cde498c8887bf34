"""Enhance stored I/Q frames with a trained generator:
``python -m ofdmgan_tpu_torch.enhance`` (counterpart of the repository's
``enhance.py``, with its flags).

Reads frames from a ``.npy``, channels-last ``[N, L, 2]`` or the
reference's ``[N, 2, L]`` (detected, and kept on output), runs the
generator in chunks of ``--batch_size`` frames and writes the enhanced
frames. ``--int_mode rtl|float_ref|rtl_residual`` runs the mini
generator's Q1.7/Q8.8 integer datapath instead, the bit-true twin of the
deployed hardware. ``--checkpoint`` is a checkpoint directory of the port
or a generator ``.npz``. Runs on the GPU unless ``--device cpu``, the
integer datapath too.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Enhance OFDM I/Q frames")
    ap.add_argument("--checkpoint", required=True, help="checkpoint directory or generator .npz")
    ap.add_argument("--input", required=True, help=".npy of frames [N,L,2] or [N,2,L]")
    ap.add_argument("--output", required=True, help=".npy for enhanced frames")
    ap.add_argument("--model", choices=["mini", "full"], default="mini")
    ap.add_argument("--frame_length", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=8192)
    ap.add_argument("--int_mode", choices=["rtl", "float_ref", "rtl_residual"], default=None,
                    help="run the Q1.7/Q8.8 integer datapath (mini only)")
    ap.add_argument("--residual", action="store_true",
                    help="mini generator with the input-residual head (must match the "
                         "checkpoint's training head; for integer inference of residual "
                         "checkpoints pass --int_mode rtl_residual)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.residual and args.int_mode == "rtl":
        raise SystemExit("--residual checkpoints deploy on the 'rtl_residual' "
                         "integer head; pass --int_mode rtl_residual")
    if args.int_mode and args.model != "mini":
        raise SystemExit("--int_mode supports the mini (ROM-deployable) model")

    import numpy as np
    import torch

    from .device import resolve_device
    from .eval.loading import build_generator
    from .utils.params_io import load_params_tree

    dev = resolve_device(args.device)
    x = np.load(args.input).astype(np.float32)
    if x.ndim != 3:
        raise SystemExit(f"expected 3-D frames, got shape {x.shape}")
    ref_layout = x.shape[1] == 2 and x.shape[2] != 2   # the reference's [N, 2, L]
    if ref_layout:
        x = np.transpose(x, (0, 2, 1))
    n, length = x.shape[0], x.shape[1]
    fl = args.frame_length or length
    if fl != length:
        raise SystemExit(f"frames have length {length}, --frame_length says {fl}")

    gen = build_generator(load_params_tree(args.checkpoint), args.model, fl,
                          residual=args.residual)
    if args.int_mode:
        from .quant import intsim

        ip = intsim.quantize_weights_rtl(gen, "generator")

        def fwd(frames):
            return intsim.q88_to_float(intsim.generator_int_forward(
                ip, intsim.float_to_q88(frames), args.int_mode))
    else:
        fwd = gen.to(dev)
    chunks = []
    with torch.no_grad():
        for i in range(0, n, args.batch_size):
            chunks.append(fwd(torch.from_numpy(x[i:i + args.batch_size]).to(dev)).cpu().numpy())
    out = np.concatenate(chunks, axis=0)
    if ref_layout:
        out = np.transpose(out, (0, 2, 1))
    np.save(args.output, out)
    print(f"Enhanced {n} frames (L={length}, "
          f"{'int ' + args.int_mode if args.int_mode else 'float'}"
          f"{', reference layout' if ref_layout else ''}) -> {args.output}")


if __name__ == "__main__":
    sys.exit(main())
