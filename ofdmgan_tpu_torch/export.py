"""Export a trained generator (and critic) as the FPGA bundle:
``python -m ofdmgan_tpu_torch.export --checkpoint DIR`` (counterpart of the
repository's ``export.py``, with its flags).

``--checkpoint`` is a checkpoint directory of the port or the JAX package's
``.npz`` layout (``params_g.npz``, ``params_d.npz``) or a generator
``.npz``. The bundle goes to ``--export_dir``/generator (and
``/discriminator`` with ``--discriminator``); ``--bias_format`` writes the
biases as float32 (the reference's) or int32 Q16.16. Runs on the host.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Export trained generator weights")
    parser.add_argument("--checkpoint", required=True,
                        help="checkpoint directory (e.g. checkpoints/best_model) or generator .npz")
    parser.add_argument("--export_dir", default="./export")
    parser.add_argument("--discriminator", action="store_true",
                        help="also export the critic (not possible in the reference)")
    parser.add_argument("--bias_format", choices=["float32", "int32_q1616"], default="float32")
    args = parser.parse_args(argv)

    from .quant.export import export_discriminator, export_generator_checkpoint
    from .utils.params_io import load_params_tree

    ckpt, out = Path(args.checkpoint), Path(args.export_dir)
    meta = export_generator_checkpoint(args.checkpoint, args.export_dir,
                                       write_bias_format=args.bias_format)
    print(f"Exported {len(meta['layers'])} generator layers to {out / 'generator'}")
    if args.discriminator and (ckpt / "params_d.npz").is_file():
        meta_d = export_discriminator(load_params_tree(str(ckpt / "params_d.npz")),
                                      str(out / "discriminator"),
                                      write_bias_format=args.bias_format)
        print(f"Exported {len(meta_d['layers'])} discriminator layers to {out / 'discriminator'}")


if __name__ == "__main__":
    main()
