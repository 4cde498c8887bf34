"""The RTL-residual handoff bundle for a hardware engineer with a Verilog
simulator: ``python -m ofdmgan_tpu_torch.make_rtl_handoff`` (counterpart
of ``scripts/make_rtl_handoff.py``, with the output paths as flags).

From a generator trained with ``--rtl_qat --residual`` it writes:

* ``--rom_file``: the weight/bias ROM source, the address map of
  ``rtl/ofdmGAN/weight_rom.v:27-39``;
* ``--out_dir``/``weights.hex``, ``biases.hex``: the same ROM images as
  flat ``$readmemh`` memories (2048 x 8-bit Q1.7, 64 x 16-bit Q8.8);
* ``--out_dir``/``vectors/<name>_{in,out}.hex``: input frames and their
  bit-true expected outputs (Q8.8, 4-hex-digit two's complement, one word
  per line, channel-first: 16 I samples then 16 Q samples, the
  golden-vector convention) over the reference testbench's patterns
  (tb_generator_mini.v:214-430) and QPSK-OFDM frames;
* ``--out_dir``/``manifest.json``: the vectors with their CRC32s.

The expected outputs come from ``quant/intsim.py`` mode ``"rtl_residual"``
on ``--device`` (the GPU unless ``cpu``); the native C++ engine
``native/fixsim.cpp`` computes the same words (``verify/cosim.py``). The
files equal the JAX package's but for the name of this package's engine
in the manifest and of its ROM generator in one comment of the ROM.
"""

from __future__ import annotations

import argparse
import json
import zlib
from pathlib import Path
from typing import Any, Dict

import numpy as np

CHECKPOINT = "results/residual_checkpoints/rtl_qat/champion_params_g.npz"
OUT_DIR = "rtl/handoff_rtl_residual"
ROM_FILE = "rtl/weight_rom_rtl_residual.v"
ENGINES = ["ofdmgan_tpu_torch/quant/intsim.py:generator_int_forward",
           "native/fixsim.cpp:fixsim_generator_forward_res"]


def make_test_frames(frame_length: int = 16) -> Dict[str, np.ndarray]:
    """Pattern set mirroring tb_generator_mini.v:214-430 (zero / DC /
    impulse / sine / ramp) plus QPSK-OFDM scenarios at several SNRs.
    Returns name -> float frame [L, 2]."""
    L = frame_length
    rng = np.random.default_rng(42)
    t = np.arange(L)
    frames = {
        "zero": np.zeros((L, 2)),
        "dc": np.full((L, 2), 0.5),
        "impulse": np.zeros((L, 2)),
        "sine": np.stack([0.7 * np.sin(2 * np.pi * t / L),
                          0.7 * np.cos(2 * np.pi * t / L)], -1),
        "ramp": np.stack([np.linspace(-0.9, 0.9, L)] * 2, -1),
        "saturating": np.stack([np.linspace(-2.0, 2.0, L)] * 2, -1),
    }
    frames["impulse"][L // 2, 0] = 1.0
    # OFDM-like frames: IFFT of random QPSK symbols + AWGN, joint-normalized
    # the way the training datagen does (utils/dataset.py:284-287 semantics)
    for name, snr_db in [("ofdm_clean", None), ("ofdm_snr20", 20.0),
                         ("ofdm_snr10", 10.0), ("ofdm_snr0", 0.0)]:
        sym = (rng.choice([-1, 1], L) + 1j * rng.choice([-1, 1], L)) / np.sqrt(2)
        x = np.fft.ifft(sym) * np.sqrt(L)
        if snr_db is not None:
            p = np.mean(np.abs(x) ** 2)
            n = np.sqrt(p / 10 ** (snr_db / 10) / 2)
            x = x + n * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
        iq = np.stack([x.real, x.imag], -1)
        frames[name] = iq / max(1e-9, np.abs(iq).max())
    return frames


def write_bundle(params, out_dir: str, rom_file: str, checkpoint: str, device) -> Dict[str, Any]:
    """Write the bundle for the generator ``params`` (a model of the port
    or a flax-layout tree) with the integer datapath on ``device``;
    ``checkpoint`` names its source in the manifest. Returns the manifest."""
    import torch

    from .quant import intsim
    from .quant.rom_codegen import generate_rom_verilog, pack_rom_arrays
    from .verify.golden import write_hex

    ip = intsim.quantize_weights_rtl(params, "generator")
    Path(rom_file).parent.mkdir(parents=True, exist_ok=True)
    nw, nb = generate_rom_verilog(params, None, rom_file, int_source="q17")
    print(f"{rom_file}: {nw} weights, {nb} biases (RTL-residual generator)")

    out = Path(out_dir)
    (out / "vectors").mkdir(parents=True, exist_ok=True)
    weights, biases = pack_rom_arrays(params, None, int_source="q17")
    with open(out / "weights.hex", "w") as f:
        for v in weights:
            f.write(f"{int(v) & 0xFF:02X}\n")
    with open(out / "biases.hex", "w") as f:
        for v in biases:
            f.write(f"{int(v) & 0xFFFF:04X}\n")

    frames = make_test_frames()
    manifest = {"checkpoint": checkpoint,
                "datapath": "rtl_residual (see docs/rtl_residual_datapath.md)",
                "format": "Q8.8 int16, 4-hex-digit two's complement, one word "
                          "per line; 16 I samples then 16 Q samples",
                "engines_agreeing": ENGINES,
                "vectors": {}}
    for name, frame in frames.items():
        xq = intsim.float_to_q88(torch.from_numpy(frame[None].astype(np.float32)).to(device))
        yq = intsim.generator_int_forward(ip, xq, "rtl_residual")
        # channel-first flatten (I samples then Q): the golden-vector convention
        in_flat = xq[0].T.cpu().numpy().astype(np.int16)
        out_flat = yq[0].T.cpu().numpy().astype(np.int16)
        write_hex(out / "vectors" / f"{name}_in.hex", in_flat)
        write_hex(out / "vectors" / f"{name}_out.hex", out_flat)
        manifest["vectors"][name] = {
            "in_crc32": zlib.crc32(in_flat.tobytes()),
            "out_crc32": zlib.crc32(out_flat.tobytes()),
            "out_range_q88": [int(out_flat.min()), int(out_flat.max())],
        }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    print(f"{out}: {len(frames)} vector pairs + ROM hex images + manifest")
    return manifest


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description="Write the RTL-residual handoff bundle")
    ap.add_argument("--checkpoint", default=CHECKPOINT,
                    help="generator .npz or checkpoint directory of an --rtl_qat --residual run")
    ap.add_argument("--out_dir", default=OUT_DIR)
    ap.add_argument("--rom_file", default=ROM_FILE)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .device import resolve_device
    from .utils.params_io import load_params_tree

    dev = resolve_device(args.device)
    return write_bundle(load_params_tree(args.checkpoint), args.out_dir, args.rom_file,
                        args.checkpoint, dev)


if __name__ == "__main__":
    main()
