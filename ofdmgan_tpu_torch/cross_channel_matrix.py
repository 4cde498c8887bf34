"""Cross-channel generalisation of the mini residual champions:
``python -m ofdmgan_tpu_torch.cross_channel_matrix`` (counterpart of the
repository's ``scripts/cross_channel_matrix.py``).

Every residual-head champion is evaluated on every channel family's
validation frames (the same protocol as ``eval_checkpoint``: seed 1234,
``--batches`` x ``--batch_size`` frames from the FFT datagen, SNR 0 to
30 dB, L = 16), beside the identity baseline of each channel: the linear
matrix (trained on and evaluated on AWGN, Rayleigh, Rician, multipath) and
the nonlinear 2 x 2 (AWGN and multipath with the PA chain). Writes the
matrix as JSON to ``--out`` and prints it as a table.

The champions are the JAX package's committed ones under ``results/``. The
port reads ``.npz`` files and checkpoint directories of either package's
``.npz`` layout; a champion kept only as an Orbax directory is listed as
skipped (``scripts/extract_champion.py`` of the JAX package writes its
``.npz``). ``results/`` is not copied to the GPU's machine, so this runs on
the CPU there is (``--device cpu``) unless the files are supplied.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

import torch

LINEAR_MODELS = {
    "awgn": "results/residual_checkpoints/linear/champion_params_g.npz",
    "rayleigh": "results/fading/rayleigh_checkpoint",
    "rician": "results/fading/rician_checkpoint",
    "multipath": "results/fading/multipath_linear_checkpoint",
}
NONLINEAR_MODELS = {
    "awgn": "results/residual_checkpoints/nonlinear/champion_params_g.npz",
    "multipath": "results/fading/multipath_nonlinear_checkpoint",
}
CHANNELS = ["awgn", "rayleigh", "rician", "multipath"]


def sweep(apply: Callable, batches: Iterable[Dict[str, torch.Tensor]]) -> Tuple[float, float]:
    """Mean validation L1 of ``apply`` over ``batches`` and its standard error."""
    with torch.no_grad():
        l1s = torch.stack([(apply(b["noisy"]) - b["clean"]).abs().mean() for b in batches])
    n = l1s.numel()
    return float(l1s.mean()), float(l1s.std(correction=0)) / math.sqrt(n)


def load_generator(path: Path, device):
    """The residual-head mini generator of ``path``, or ``None`` where the
    port cannot read it (missing, or an Orbax directory)."""
    from .eval.loading import build_generator
    from .utils.params_io import load_params_tree

    try:
        tree = load_params_tree(str(path))
    except FileNotFoundError as err:
        print(f"skip {path}: {err}", flush=True)
        return None
    return build_generator(tree, "mini", 16, residual=True).to(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Cross-channel L1 matrix of the mini champions")
    ap.add_argument("--batches", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--root", default=".", help="the directory that holds results/")
    ap.add_argument("--out", default="build/cross_channel_matrix.json")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .device import resolve_device
    from .signal.datagen import DatagenConfig, synthetic_batch

    dev = resolve_device(args.device)
    root = Path(args.root)
    results = {}
    for nonlinear, model_set, tag in ((False, LINEAR_MODELS, "linear"),
                                      (True, NONLINEAR_MODELS, "nonlinear")):
        models = {k: load_generator(root / p, dev) for k, p in model_set.items()}
        grid = {}
        for ch in (list(NONLINEAR_MODELS) if nonlinear else CHANNELS):
            dg = DatagenConfig.make(frame_length=16, snr_range=(0, 30), channel_type=ch,
                                    nonlinear=nonlinear, pa_saturation=0.8)
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            batches = [synthetic_batch(gen, args.batch_size, dg) for _ in range(args.batches)]
            col = {"identity": sweep(lambda x: x, batches)}
            for trained_on, g in models.items():
                if g is not None:
                    col[f"trained_{trained_on}"] = sweep(g, batches)
            grid[ch] = col
            print(f"[{tag}] eval channel {ch}: " + "  ".join(
                f"{k}={v[0]:.4f}" for k, v in col.items()), flush=True)
        results[tag] = grid

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(
        {"protocol": f"{args.batches}x{args.batch_size} paired frames, seed {args.seed}, "
                     f"L=16, SNR 0-30, {dev.type}",
         "value": "val L1 (mean, sem)", **results}, indent=1))
    print(f"wrote {out}")
    for tag, grid in results.items():
        rows = ["identity"] + sorted({r for col in grid.values() for r in col} - {"identity"})
        print(f"\n{tag}: rows=model, cols=eval channel (val L1)")
        print("model".ljust(22) + "".join(c.rjust(11) for c in grid))
        for r in rows:
            print(r.ljust(22) + "".join(
                (f"{grid[c][r][0]:.4f}" if r in grid[c] else "-").rjust(11) for c in grid))
    return results


if __name__ == "__main__":
    main()
