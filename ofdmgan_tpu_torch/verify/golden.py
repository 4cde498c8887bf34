"""Golden vectors for the RTL testbenches, and the parity check of their
Q8.8 encoding (counterpart of ``ofdmgan_tpu/verify/golden.py``).

One forward pass of a generator writes seven files, as the JAX package's
``generate_golden_vectors`` does:

* ``input_float.npy`` / ``output_float.npy``: float32, channel-first
  ``[1, 2, L]``;
* ``input_q88.npy`` / ``output_q88.npy``: int16, ``value * 256``
  truncated toward zero (numpy's ``astype``);
* ``input.hex`` / ``output.hex``: one 4-digit uppercase two's-complement
  word per line, row-major (all I samples, then all Q samples);
* ``golden_metadata.json``: the shapes, the format and the number of
  conv/dense layers.

The encoding runs in numpy on the host, after the output is copied off the
device, so the card and the CPU encode equal floats identically.
``check_reference_encoding_parity`` re-encodes a committed golden-vector
directory's floats and compares them with its int16 and hex files.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from ..utils.jax_params import keys_of


def q88_int16(x: np.ndarray) -> np.ndarray:
    """value*256 with truncation toward zero — int16 cast semantics."""
    return (np.asarray(x, np.float32) * 256).astype(np.int16)


def write_hex(path: Path, q88: np.ndarray):
    with open(path, "w") as f:
        for v in q88.flatten():
            f.write(f"{int(v) & 0xFFFF:04X}\n")


def read_hex(path: Path) -> np.ndarray:
    vals = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        u = int(line, 16)
        vals.append(u - 0x10000 if u >= 0x8000 else u)
    return np.asarray(vals, np.int16)


def generate_golden_vectors(model: torch.nn.Module, input_ncl: np.ndarray,
                            output_dir: str) -> Dict[str, Any]:
    """Run ``model`` once, on the device of its parameters, on
    ``input_ncl`` (``[1, C, L]`` float32, the file layout) and write the
    golden-vector bundle into ``output_dir``; returns its metadata."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    input_ncl = np.asarray(input_ncl, np.float32)
    dev = next(model.parameters()).device
    with torch.no_grad():
        y = model(torch.tensor(input_ncl, device=dev).transpose(1, 2))
    y_ncl = np.ascontiguousarray(y.transpose(1, 2).cpu().numpy(), np.float32)
    # the reference hooks every Conv1d/Linear (proof/verification.py:266-280):
    # one flax "kernel" leaf each
    n_layers = sum(1 for path in keys_of(model).values() if path.endswith("kernel"))

    np.save(out / "input_float.npy", input_ncl)
    np.save(out / "output_float.npy", y_ncl)
    in_q = q88_int16(input_ncl)
    out_q = q88_int16(y_ncl)
    np.save(out / "input_q88.npy", in_q)
    np.save(out / "output_q88.npy", out_q)
    write_hex(out / "input.hex", in_q)
    write_hex(out / "output.hex", out_q)

    metadata = {
        "input_shape": list(input_ncl.shape),
        "output_shape": list(y_ncl.shape),
        "format": "Q8.8 fixed-point",
        "layers": n_layers,
    }
    with open(out / "golden_metadata.json", "w") as f:
        json.dump(metadata, f, indent=2)
    return metadata


def check_reference_encoding_parity(ref_dir: str) -> Dict[str, bool]:
    """Bit-exactness against a checked-in golden-vector directory.

    For each of input/output: re-encode the directory's float .npy with
    ``q88_int16`` and compare against its int16 .npy and .hex files.
    """
    ref = Path(ref_dir)
    results = {}
    for name in ("input", "output"):
        f = np.load(ref / f"{name}_float.npy")
        q_ref = np.load(ref / f"{name}_q88.npy")
        q_ours = q88_int16(f)
        hex_ref = read_hex(ref / f"{name}.hex")
        results[f"{name}_npy_bitexact"] = bool(np.array_equal(q_ours, q_ref))
        results[f"{name}_hex_bitexact"] = bool(np.array_equal(q_ours.flatten(), hex_ref))
    return results
