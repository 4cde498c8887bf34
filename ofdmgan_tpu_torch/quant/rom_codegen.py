"""The Verilog weight and bias ROM from trained parameters (counterpart of
``ofdmgan_tpu/quant/rom_codegen.py``), with the address map of
``rtl/ofdmGAN/weight_rom.v:27-39``:

  weight ROM (2048 x 8-bit Q1.7):
    generator   enc1 [0:23], bottleneck [24:119], dec1 [120:215]   [out][in][k]
                out_conv [216:223]                                 centre tap, [out][in]
    critic      conv1 [256:351], conv2 [352:735], dense [736:751]
  bias ROM (64 x 16-bit Q8.8):
    generator   enc1 [0:3], bottleneck [4:11], dec1 [12:15], out_conv [16:17]
    critic      conv1 [32:39], conv2 [40:55], dense [56]

``int_source`` says where the Q1.7 integers come from: ``"q17"``,
round(w * 128) (``intsim``'s quantization), or ``"int8"``, the export's
per-channel scaled int8 (the reference's own ROM fed those to the Q1.7
datapath). Parameters are a model of the port or a flax-layout tree. The
files equal the reference's but for the generator's name in one comment.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Tuple

import numpy as np

from .export import discriminator_layers, generator_layers, quantize_layer_int8
from .intsim import IntDiscParams, IntGenParams, IntLayer, quantize_weights_rtl

WEIGHT_DEPTH = 2048
BIAS_DEPTH = 64
GENERATED_BY = "// weight_rom / bias_rom — generated by ofdmgan_tpu_torch.quant.rom_codegen"

# (name, weight base, bias base, centre tap only)
GEN_LAYOUT = [("enc1", 0, 0, False), ("bottleneck", 24, 4, False), ("dec1", 120, 12, False),
              ("out_conv", 216, 16, True)]
DISC_LAYOUT = [("conv1", 256, 32, False), ("conv2", 352, 40, False), ("dense", 736, 56, False)]

# layer -> weight shape in ROM order (out_conv: its centre tap; dense: 2-D)
ROM_SHAPES = {"enc1": (4, 2, 3), "bottleneck": (8, 4, 3), "dec1": (4, 8, 3), "out_conv": (2, 4),
              "conv1": (8, 4, 3), "conv2": (16, 8, 3), "dense": (1, 16)}


def _hex8(v: int) -> str:
    return f"8'h{int(v) & 0xFF:02X}"


def _hex16(v: int) -> str:
    return f"16'h{int(v) & 0xFFFF:04X}"


def _layer_ints(params, model: str, int_source: str):
    """-> [(layout entry, weight ints flat in [out][in][k] order, bias ints)]."""
    layout = GEN_LAYOUT if model == "generator" else DISC_LAYOUT
    if int_source == "q17":
        layers = list(quantize_weights_rtl(params, model))
        weights = [np.asarray(layer.weight) for layer in layers]
        biases = [np.asarray(layer.bias) for layer in layers]
    elif int_source == "int8":
        specs = generator_layers(params) if model == "generator" else discriminator_layers(params)
        weights = [quantize_layer_int8(spec.weight)[0].astype(np.int32) for spec in specs]
        biases = [np.clip(np.round(spec.bias * 256.0), -32768, 32767).astype(np.int32)
                  for spec in specs]
    else:
        raise ValueError(int_source)
    out = []
    for entry, w, b in zip(layout, weights, biases):
        if entry[3]:   # [out, in, k] -> [out, in]
            w = w[:, :, w.shape[2] // 2]
        out.append((entry, w.flatten(), b.flatten()))
    return out


def pack_rom_arrays(gen_params=None, disc_params=None,
                    int_source: str = "q17") -> Tuple[np.ndarray, np.ndarray]:
    """Flat ROM images (weights[2048] int8, biases[64] int16) in the RTL's
    address map; a region without parameters stays zero."""
    weights = np.zeros(WEIGHT_DEPTH, np.int8)
    biases = np.zeros(BIAS_DEPTH, np.int16)
    layers = []
    if gen_params is not None:
        layers += _layer_ints(gen_params, "generator", int_source)
    if disc_params is not None:
        layers += _layer_ints(disc_params, "discriminator", int_source)
    for (_, wbase, bbase, _), w, b in layers:
        weights[wbase:wbase + len(w)] = w.astype(np.int8)
        biases[bbase:bbase + len(b)] = b.astype(np.int16)
    return weights, biases


def _rom_lines(weight_entries, bias_entries, note: str, comments=None) -> List[str]:
    comments = comments or {}
    lines = ["//" + "=" * 78, GENERATED_BY, note, "//" + "=" * 78, "", "`timescale 1ns / 1ps", "",
             "module weight_rom #(",
             "    parameter WEIGHT_WIDTH = 8,",
             f"    parameter DEPTH        = {WEIGHT_DEPTH},",
             "    parameter ADDR_WIDTH   = 11",
             ")(",
             "    input  wire                            clk,",
             "    input  wire [ADDR_WIDTH-1:0]           addr,",
             "    output reg  signed [WEIGHT_WIDTH-1:0]  data",
             ");",
             "    reg [WEIGHT_WIDTH-1:0] weights [0:DEPTH-1];",
             "    integer i;",
             "    initial begin",
             "        for (i = 0; i < DEPTH; i = i + 1) weights[i] = 8'h00;"]
    for addr, val in weight_entries:
        tag = f"  // {comments[addr]}" if addr in comments else ""
        lines.append(f"        weights[{addr:4d}] = {_hex8(val)};{tag}")
    lines += ["    end",
              "    always @(posedge clk) data <= weights[addr];",
              "endmodule", "",
              "module bias_rom #(",
              "    parameter DATA_WIDTH = 16,",
              f"    parameter DEPTH      = {BIAS_DEPTH},",
              "    parameter ADDR_WIDTH = 6",
              ")(",
              "    input  wire                          clk,",
              "    input  wire [ADDR_WIDTH-1:0]         addr,",
              "    output reg  signed [DATA_WIDTH-1:0]  data",
              ");",
              "    reg [DATA_WIDTH-1:0] biases [0:DEPTH-1];",
              "    integer i;",
              "    initial begin",
              "        for (i = 0; i < DEPTH; i = i + 1) biases[i] = 16'h0000;"]
    for addr, val in bias_entries:
        lines.append(f"        biases[{addr:2d}] = {_hex16(val)};")
    lines += ["    end",
              "    always @(posedge clk) data <= biases[addr];",
              "endmodule"]
    return lines


def generate_rom_verilog(gen_params, disc_params=None, output_file: str = "weight_rom.v",
                         int_source: str = "q17") -> Tuple[int, int]:
    """Write ``weight_rom``/``bias_rom`` with the trained values; returns
    (weights written, biases written)."""
    entries, bias_entries, comments = [], [], {}
    layers = _layer_ints(gen_params, "generator", int_source)
    if disc_params is not None:
        layers += _layer_ints(disc_params, "discriminator", int_source)
    for (name, wbase, bbase, _), w, b in layers:
        entries += [(wbase + i, int(v)) for i, v in enumerate(w)]
        bias_entries += [(bbase + i, int(v)) for i, v in enumerate(b)]
        comments[wbase] = name
    note = (f"// int_source: {int_source}  (Q1.7 weights, Q8.8 biases)\n"
            "// Address map identical to rtl/ofdmGAN/weight_rom.v:27-39")
    Path(output_file).write_text("\n".join(_rom_lines(entries, bias_entries, note, comments))
                                 + "\n")
    return len(entries), len(bias_entries)


def slice_full_export_to_mini(export_dir: str,
                              bias_format: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    """A full U-Net export bundle -> mini ROM images, by the reference's
    channel slicing (``utils/export_mini_weights.py:45-145``):
    enc1 <- enc1_1[:4], bottleneck <- enc2_1[:8, :4], dec1 <- dec5_1[:4, :8],
    out_conv <- final[:, :4, centre]. ``bias_format`` decodes the bias files:
    ``"float32"`` times 256, or ``"int32_q1616"`` shifted ``>> 8``. The critic
    region stays zero."""
    d = Path(export_dir)

    def w(name, shape):
        return np.fromfile(d / f"{name}_weights.bin", dtype=np.int8).reshape(shape)

    def b(name, n):
        if bias_format == "int32_q1616":
            raw = np.fromfile(d / f"{name}_bias.bin", dtype=np.int32)[:n]
            return np.clip((raw >> 8).astype(np.int64), -32768, 32767)
        raw = np.fromfile(d / f"{name}_bias.bin", dtype=np.float32)[:n]
        return np.clip(np.round(raw * 256.0).astype(np.int64), -32768, 32767)

    weights = np.zeros(WEIGHT_DEPTH, np.int8)
    biases = np.zeros(BIAS_DEPTH, np.int16)
    weights[0:24] = w("enc1_1", (-1, 2, 3))[:4].flatten()
    biases[0:4] = b("enc1_1", 4)
    weights[24:120] = w("enc2_1", (64, 32, 3))[:8, :4].flatten()
    biases[4:12] = b("enc2_1", 8)
    weights[120:216] = w("dec5_1", (32, 32, 3))[:4, :8].flatten()
    biases[12:16] = b("dec5_1", 4)
    weights[216:224] = w("final", (2, 32, 3))[:, :4, 1].flatten()
    biases[16:18] = b("final", 2)
    return weights, biases


def generate_mini_rom_from_full_export(export_dir: str, output_file: str,
                                       bias_format: str = "float32") -> Tuple[int, int]:
    """A full U-Net export directory -> the mini ROM's Verilog source."""
    weights, biases = slice_full_export_to_mini(export_dir, bias_format)
    entries = [(i, int(v)) for i, v in enumerate(weights[:224])]
    bias_entries = [(i, int(v)) for i, v in enumerate(biases[:18])]
    lines = _rom_lines(entries, bias_entries, f"// sliced from full-model export at {export_dir}")
    Path(output_file).write_text("\n".join(lines) + "\n")
    return len(entries), len(bias_entries)


def unpack_rom_arrays(weights: np.ndarray, biases: np.ndarray):
    """The inverse of ``pack_rom_arrays``: ROM images -> the integer
    parameters ``intsim`` runs, ``(IntGenParams, IntDiscParams)``."""
    def layer(name, wbase, bbase):
        shape = ROM_SHAPES[name]
        n = int(np.prod(shape))
        return IntLayer(np.asarray(weights[wbase:wbase + n], np.int32).reshape(shape),
                        np.asarray(biases[bbase:bbase + shape[0]], np.int32))

    return (IntGenParams(*(layer(n, wb, bb) for n, wb, bb, _ in GEN_LAYOUT)),
            IntDiscParams(*(layer(n, wb, bb) for n, wb, bb, _ in DISC_LAYOUT)))


def parse_rom_verilog(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A ``weight_rom.v`` (this module's or the reference's) -> (weights[2048],
    biases[64]) as int32."""
    weights = np.zeros(WEIGHT_DEPTH, np.int32)
    biases = np.zeros(BIAS_DEPTH, np.int32)
    text = Path(path).read_text()
    for m in re.finditer(r"weights\[\s*(\d+)\]\s*=\s*8'h([0-9A-Fa-f]{2})", text):
        v = int(m.group(2), 16)
        weights[int(m.group(1))] = v - 256 if v >= 128 else v
    for m in re.finditer(r"biases\[\s*(\d+)\]\s*=\s*16'h([0-9A-Fa-f]{4})", text):
        v = int(m.group(2), 16)
        biases[int(m.group(1))] = v - 65536 if v >= 32768 else v
    return weights, biases
