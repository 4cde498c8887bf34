"""A full U-Net export bundle -> the mini RTL's Verilog weight ROM:
``python -m ofdmgan_tpu_torch.export_mini_weights`` (counterpart of the
repository's ``export_mini_weights.py``, with its flags).

Slices the full 5-level U-Net's export in ``--export_dir`` down to the mini
architecture and writes ``weight_rom``/``bias_rom`` in the RTL's address map
to ``--output``. Without an export there, it writes the ROM of a fresh mini
pair made from seed 0 (the reference falls back to random weights).
``--bias_format`` says how the bias files are read. Runs on the host.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Export trained weights to Verilog ROM")
    parser.add_argument("--export_dir", default="export/generator",
                        help="directory with the full model's exported .bin files")
    parser.add_argument("--output", default="rtl/weight_rom.v", help="output Verilog file")
    parser.add_argument("--bias_format", choices=["float32", "int32_q1616"], default="float32",
                        help="how to read the _bias.bin files (the reference writes float32 "
                             "but its own reader assumed int32 Q16.16)")
    args = parser.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)

    from .quant.rom_codegen import generate_mini_rom_from_full_export, generate_rom_verilog

    if os.path.exists(os.path.join(args.export_dir, "enc1_1_weights.bin")):
        print(f"Slicing full-model export at {args.export_dir} ...")
        nw, nb = generate_mini_rom_from_full_export(args.export_dir, args.output,
                                                    args.bias_format)
    else:
        print(f"Export not found at {args.export_dir}; using fresh mini weights")
        from .config import Config
        from .training.trainer import build_models

        generator, critic = build_models(Config(), "mini", seed=0)
        nw, nb = generate_rom_verilog(generator, critic, args.output)
    print(f"Generated {args.output}: {nw} weights, {nb} biases")


if __name__ == "__main__":
    main()
