"""Readings that set the limits of a cell's comparison, in one process:

    python3 -m perfbench.calibrate --workload <cell> --seeds 11 12 ... \
        [--variants sound control unchanged half_batch altered] [--out FILE]

For each variant and seed: the program's first ``checked_steps`` outer
steps from the seed's weights and draws, its chunk's warm-up and one more
call of the chunk (the checked chunk), its state freed, then the plain
reference over the same steps and chunk, and the numbers of
``check.py``. The
variants: ``sound``, the program as the cell states it; ``control``, the
same step with TF32 allowed (``matmul_precision="tensorfloat32"``), the
nearest precision below the configuration's float32; and each fault of
``faults.py``. No window runs: training's readings need none.

Prints a line a reading to standard error and, as its last line on
standard output, one JSON object: the readings, and for each number the
lower reading (the largest over sound runs) and the smallest reading of
each other variant. Needs the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from . import check, spec
from .faults import FAULTS, plant
from .program import Program, checked_chunk, checked_steps, make_weights

VARIANTS = ("sound", "control") + FAULTS


def reading(name: str, seed: int, variant: str, device: torch.device) -> dict:
    """The numbers of one variant's checked steps and chunk from ``seed``,
    and each checked step's loss gaps."""
    s = spec.cell(name)
    config, cell = s["config"], s["cell"]
    seed %= 2 ** 63
    weights = make_weights(config, seed, device)
    weights0 = {net: {k: v.clone() for k, v in ps.items()} for net, ps in weights.items()}
    precision = "tensorfloat32" if variant == "control" else None
    with plant(variant if variant in FAULTS else None):
        try:
            program = Program(config, cell, weights, seed, device, precision)
            prog = checked_steps(program, weights0, cell["checked_steps"])
            chunk = program.make_chunk()
            for _ in range(2 if program.graphed else 1):   # the warm-up chunk; the capture
                chunk()
            chunk_prog = checked_chunk(program, chunk)
        except RuntimeError as err:   # a control that crashes has failed
            return {"error": str(err)[:400]}
        del program, chunk
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    ref = check.reference_steps(config, cell, weights0, prog["draws"], device)
    chunk_ref = check.reference_chunk(config, cell, chunk_prog["start"], chunk_prog["draws"],
                                      device)
    return {**check.numbers(prog, ref), **check.chunk_numbers(chunk_prog, chunk_ref),
            "loss_gaps": check.loss_gaps(prog, ref)}


def summarize(readings: dict) -> dict:
    out = {}
    for num in check.NUMBERS:
        row = {}
        for variant, by_seed in readings.items():
            vals = [r[num] for r in by_seed.values() if num in r]   # a crash has none
            if vals:
                row["lower" if variant == "sound" else variant] = (
                    max(vals) if variant == "sound" else min(vals))
        out[num] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings that set a cell's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=VARIANTS)
    ap.add_argument("--control_seeds", type=int, default=0,
                    help="take the other variants on the first N seeds only (0: all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    readings = {}
    for variant in args.variants:
        seeds = args.seeds
        if variant != "sound" and args.control_seeds:
            seeds = seeds[:args.control_seeds]
        readings[variant] = {}
        for seed in seeds:
            r = reading(args.workload, seed, variant, device)
            readings[variant][str(seed)] = r
            print(f"{args.workload} {variant} {seed} {r}", file=sys.stderr, flush=True)
    result = {"workload": args.workload, "readings": readings, "summary": summarize(readings)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
