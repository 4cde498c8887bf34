"""Serving export: a trained generator's forward as a ``torch.export``
program, ``python -m ofdmgan_tpu_torch.export_serving`` (counterpart of the
repository's ``export_serving.py``).

The JAX package serializes its serving forward to StableHLO. Here the
forward, its trained parameters held in the module, is traced with
``torch.export.export`` and written with ``torch.export.save`` to
``<out>.pt2``, which ``torch.export.load(path).module()(x)`` runs without
this package on the import path. ``<out>.metadata.json`` describes it.

* The batch dimension is dynamic by default (``--batch symbolic``: one
  program serves any batch; it is traced at batch 2, since export
  specialises a sample batch of 0 or 1), or fixed (``--batch N``).
* The full model exports the serving forward (``models/unet_infer.py``:
  the fused upsample-and-conv decoder with bfloat16 weights and
  activations, as ``eval_checkpoint --serving`` runs it); the mini its
  module forward (``--residual``, ``--act_dtype``). The JAX side's flat
  mini apply is a TPU layout and is not ported.
* A program is traced for one device: tensors it creates carry that
  device. It is traced on the device it will serve on (the GPU unless
  ``--device cpu``), and the metadata names it.
* ``--platforms``/``--platform`` of the JAX script have no counterpart:
  the program is PyTorch's own format, not a lowering for named platforms.
  An AOTInductor package (compiled code) needs a compiler toolchain and
  Triton at export time and is not written.

Round trip (``--selftest``, on by default): load the written bytes and
compare them with the in-process forward on random frames, within atol
1e-5 at float32 and 1e-2 at bfloat16, as the JAX script does; exit
non-zero on failure.

Usage:
  python -m ofdmgan_tpu_torch.export_serving --model full \\
      --checkpoint results/full_unet_run/champion_params_g.npz --out serving/full_champion
  python -m ofdmgan_tpu_torch.export_serving --model mini \\
      --checkpoint results/residual_checkpoints/nonlinear/champion_params_g.npz \\
      --residual --out serving/mini_residual
"""

from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path

import torch
from torch import nn

FULL_FRAME_LENGTH = 1024
SELFTEST_ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
SAMPLE_BATCH = 2   # a dynamic batch needs a sample of at least 2


class ServingForward(nn.Module):
    """``[B, L, 2]`` float32 frames -> enhanced float32 frames: the full
    U-Net's fused serving forward at ``act_dtype`` or the mini module's."""

    def __init__(self, generator: nn.Module, full: bool, act_dtype: torch.dtype):
        super().__init__()
        self.generator = generator
        self.full = full
        if full:
            from .models.unet_infer import make_unet_infer_apply

            self.generator.to(act_dtype)   # the weights are baked at act_dtype
            self.serve = make_unet_infer_apply(levels=generator.levels,
                                                leaky_slope=generator.leaky_slope,
                                                act_dtype=act_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.serve(self.generator, x) if self.full else self.generator(x)
        return y.float()


def build_forward(model: str, tree, residual: bool, act_dtype: str,
                  frame_length: int) -> tuple[ServingForward, int]:
    """The serving forward of the checkpoint ``tree`` (on the CPU) and its
    frame length."""
    from .eval.loading import build_generator

    if model == "full":
        gen = build_generator(tree, "full", FULL_FRAME_LENGTH)
        return ServingForward(gen, True, getattr(torch, act_dtype)), FULL_FRAME_LENGTH
    gen = build_generator(tree, "mini", frame_length, residual=residual,
                          act_dtype=None if act_dtype == "float32" else act_dtype)
    return ServingForward(gen, False, torch.float32), frame_length


def export_program(forward: nn.Module, L: int, batch, device) -> torch.export.ExportedProgram:
    """``forward`` traced on ``device`` for ``[batch, L, 2]`` float32 input;
    ``batch`` ``"symbolic"`` makes the batch dimension dynamic."""
    symbolic = batch == "symbolic"
    x = torch.zeros(SAMPLE_BATCH if symbolic else int(batch), L, 2, device=device)
    shapes = {"x": {0: torch.export.Dim("b", min=1)}} if symbolic else None
    with torch.no_grad():
        return torch.export.export(forward, (x,), dynamic_shapes=shapes)


def selftest(path: Path, forward: nn.Module, L: int, act_dtype: str, device) -> float:
    """Load ``path`` and compare it with ``forward`` on four random frames;
    raises ``SystemExit`` when they differ by ``SELFTEST_ATOL`` or more."""
    program = torch.export.load(str(path)).module()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, L, 2, generator=gen).to(device)
    with torch.no_grad():
        y_art, y_ref = program(x), forward(x)
    delta = float((y_art - y_ref).abs().max())
    tol = SELFTEST_ATOL[act_dtype]
    print(f"selftest: max |load(artifact) - in-process| = {delta:.3e} (tol {tol:g} for "
          f"{act_dtype})")
    if not (delta < tol and bool(torch.isfinite(y_art).all())):
        raise SystemExit("selftest FAILED")
    print("selftest: PASS")
    return delta


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=["mini", "full"], default="mini")
    ap.add_argument("--checkpoint", required=True,
                    help=".npz champion or checkpoint directory of either package's layout")
    ap.add_argument("--ema", action="store_true",
                    help="export a checkpoint directory's EMA generator")
    ap.add_argument("--residual", action="store_true",
                    help="mini: the input-residual head (must match how the checkpoint was "
                         "trained)")
    ap.add_argument("--act_dtype", default=None, choices=["float32", "bfloat16"],
                    help="activation (and, full: weight) dtype; default bfloat16 for full, "
                         "float32 for mini")
    ap.add_argument("--frame_length", type=int, default=16,
                    help="mini frame length (full is fixed at 1024)")
    ap.add_argument("--batch", default="symbolic",
                    help="'symbolic' (any batch size at load time) or a fixed integer")
    ap.add_argument("--out", required=True,
                    help="output prefix: writes <out>.pt2 and <out>.metadata.json")
    ap.add_argument("--no_selftest", action="store_true",
                    help="skip the load-and-compare round trip")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    """Export as the flags say; returns the metadata written."""
    args = build_parser().parse_args(argv)
    if args.act_dtype is None:
        args.act_dtype = "bfloat16" if args.model == "full" else "float32"
    if args.batch != "symbolic" and int(args.batch) < 1:
        raise SystemExit("--batch must be 'symbolic' or a positive integer")

    from .device import resolve_device
    from .utils.params_io import flatten_tree, load_params_tree

    dev = resolve_device(args.device)
    tree = load_params_tree(args.checkpoint, ema=args.ema)
    forward, L = build_forward(args.model, tree, args.residual, args.act_dtype,
                               args.frame_length)
    forward = forward.to(dev).eval()
    program = export_program(forward, L, args.batch, dev)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    art = out.with_suffix(".pt2")
    torch.export.save(program, str(art))
    blob = art.read_bytes()
    n_params = sum(int(a.size) for a in flatten_tree(tree).values())
    meta = {
        "model": args.model,
        "checkpoint": args.checkpoint,
        "residual": bool(args.residual),
        "ema": bool(args.ema),
        "act_dtype": args.act_dtype,
        "input": f"[{'b' if args.batch == 'symbolic' else int(args.batch)}, {L}, 2] float32 "
                 "(I/Q channels-last)",
        "output": "same shape, float32",
        "device": str(dev),
        "n_params_baked": n_params,
        "torch_version": torch.__version__,
        "artifact_sha256": hashlib.sha256(blob).hexdigest(),
        "artifact_bytes": len(blob),
        "load_with": "torch.export.load(path).module()(x)  # x on the device above",
    }
    out.with_suffix(".metadata.json").write_text(json.dumps(meta, indent=2) + "\n")
    print(f"wrote {art} ({len(blob)} bytes) + metadata")
    if not args.no_selftest:
        meta["selftest_max_abs_diff"] = selftest(art, forward, L, args.act_dtype, dev)
    return meta


if __name__ == "__main__":
    main()
