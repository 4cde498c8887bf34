"""One run of one cell of the benchmark of ``ofdmgan_tpu_torch``:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json``, its
configuration's file and its own file say what runs (``spec.py``).

Set-up, timed from the process's start to the window's first launch
(``setup_s``): the weights, made on the device from ``--seed``; the port's
step (``program.Program``); its first ``checked_steps`` outer steps through
the step's own call and generator, whose draws, losses, first gradients and
changes are kept for the comparison; the chunk's warm-up (a graphed chunk's
eager chunk and its capture); where the cell compares a chunk's numbers,
one more call of the chunk (a replay) from a copy of the program's state,
with its draws, losses, last gradients and changes kept for the
comparison; and a few chunks that give the rate from which the window's
count of chunks is set, so that the host never polls the device inside
the window.

The window: that many chunks, timed from the first launch to a
``torch.cuda.synchronize()``, after which the last step's losses must be
finite and both TF32 flags off. ``train_frames_per_s`` is every frame of
every outer step of the window over the whole window. The peak of
allocated device memory over set-up and window is read at its close, and
each phase's own peak goes to standard error.

With ``--trace 1`` the same window runs first; then a slice of
``trace_chunks`` chunks is traced (``trace.py``) and the per-layer metrics
are read from it (``mfu.train`` from the window).

Then the program's state is freed, the plain reference (``reference/``)
follows the checked steps from the same weights and draws, and the checked
chunk from the same state and draws, and the numbers
of ``check.py`` are held against the cell's limits. The last lines on
standard error give each number beside its limit; the last line on
standard output is the result. The run fails with no result where there is
no card, fewer cards than the cell asks for, or where JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()   # before the heavy imports: set-up counts them

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Optional  # noqa: E402

import torch  # noqa: E402

from . import check, counts, spec  # noqa: E402
from .faults import plant  # noqa: E402
from .program import Program, checked_chunk, checked_steps, make_weights  # noqa: E402
from .trace import Summary, profile_slice  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ofdmgan_tpu")
PROBE_S = 1.0   # least seconds of chunks that set the window's count


@dataclass
class Context:
    """What a metric's reader reads (``metrics/<name>.py``)."""

    config: dict
    cell: dict
    setup_s: float
    window: dict                  # steps, frames, seconds
    memory_peak_bytes: int
    trace: Optional[Summary]
    window_peak_bytes: int = 0
    counts: object = counts


def forbidden_modules() -> list:
    """The loaded modules among ``FORBIDDEN``, by whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def tf32_off() -> bool:
    return not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(x: float):
    return x if math.isfinite(x) else str(x)


def _peak(device: torch.device) -> int:
    """The peak of allocated device memory since the last call, which
    starts a new one."""
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: torch.device | None = None, overrides: dict | None = None,
             fault: str | None = None) -> dict:
    """One run of cell ``name``; returns the result line. ``device``
    defaults to the card; ``overrides`` replaces entries of the cell's file
    and ``fault`` plants a fault (``faults.py``): both for tests only."""
    s = spec.cell(name)
    config, cell = s["config"], {**s["cell"], **(overrides or {})}
    device = device or torch.device("cuda", torch.cuda.current_device())
    seed %= 2 ** 63
    marks = [("start", time.perf_counter())]   # imports, CUDA's context
    peaks = {"start": _peak(device)}   # by phase: which one sets the run's peak
    weights = make_weights(config, seed, device)
    weights0 = {net: {k: v.clone() for k, v in ps.items()} for net, ps in weights.items()}
    _sync(device)
    marks.append(("weights", time.perf_counter()))
    with plant(fault):
        program = Program(config, cell, weights, seed, device)
        marks.append(("build", time.perf_counter()))
        prog = checked_steps(program, weights0, cell["checked_steps"])
        marks.append(("checked steps", time.perf_counter()))
        peaks["checked steps"] = _peak(device)
        chunk = program.make_chunk()
        for _ in range(2 if program.graphed else 1):   # the warm-up chunk; the capture
            chunk()
        _sync(device)
        marks.append(("warm-up", time.perf_counter()))
        peaks["warm-up"] = _peak(device)
        chunk_prog = checked_chunk(program, chunk) if check.wants_chunk(cell) else None
        _sync(device)
        marks.append(("checked chunk", time.perf_counter()))
        peaks["checked chunk"] = _peak(device)
        n_probe, t0 = 0, time.perf_counter()
        while n_probe < 2 or time.perf_counter() - t0 < PROBE_S:
            chunk()
            _sync(device)
            n_probe += 1
        per_chunk = (time.perf_counter() - t0) / n_probe
        n = max(1, round(seconds / per_chunk))
        peaks["probe"] = _peak(device)
        if not tf32_off():
            raise RuntimeError("TF32 is on before the window")
        setup_s = time.perf_counter() - T_START
        t0 = time.perf_counter()
        for _ in range(n):
            metrics = chunk()
        _sync(device)
        window_s = time.perf_counter() - t0
        last = {k: float(metrics[k]) for k in ("d_loss", "g_loss")}
        if not tf32_off():
            raise RuntimeError("TF32 is on after the window")
        peaks["window"] = _peak(device)
        peak = max(peaks.values())
        t_trace = time.perf_counter()
        summary = None
        if trace and device.type == "cuda":
            k = cell["trace_chunks"]
            summary = profile_slice(chunk, lambda: [chunk() for _ in range(k)],
                                    k * program.steps_per_chunk)
        del program, chunk, metrics
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = check.reference_steps(config, cell, weights0, prog["draws"], device)
    values = check.numbers(prog, ref)
    if chunk_prog is not None:
        values.update(check.chunk_numbers(chunk_prog, check.reference_chunk(
            config, cell, chunk_prog["start"], chunk_prog["draws"], device)))
    verdict = check.verdict(values, cell["limits"])
    parts = ", ".join(f"{k} {b - a:.3f}" for (_, a), (k, b) in zip([("", T_START)] + marks, marks))
    print(f"setup {setup_s:.3f} s ({parts}, probe {setup_s - (marks[-1][1] - T_START):.3f}), "
          f"window {window_s:.3f} s ({n} chunks), trace "
          f"{t_ref - t_trace:.3f} s, reference {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    print("peak allocated GiB by phase: " + ", ".join(f"{k} {v / 2 ** 30:.4f}"
                                                     for k, v in peaks.items()), file=sys.stderr)
    steps = n * cell["chunk"]["steps"]
    finite = all(math.isfinite(v) for v in last.values())
    ctx = Context(config, cell, setup_s, {"steps": steps, "frames": steps * cell["batch"],
                                          "seconds": window_s}, peak, summary,
                  peaks["window"])
    out = {}
    for m in spec.metrics_of(name, trace):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.span_s)
    line = {"correct": finite and all(v["ok"] for v in verdict.values()), "attempted": steps,
            "failed": 0 if finite else steps, "metrics": out, "device": dev}
    if summary is not None:
        line["breakdown"] = {"device_ops": summary.top_ops(),
                             "idle_gaps": [[g, sec] for g, sec in summary.gaps]}
    checks = {k: {"value": _finite(v["value"]), "limit": v["limit"]} for k, v in verdict.items()}
    checks.update({f"window_{k}": {"value": _finite(v), "limit": "finite"}
                   for k, v in last.items()})
    line["checks"] = checks
    return line


def card_note(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not read"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card", file=sys.stderr)
        return 2
    chips = spec.cell(args.workload)["entry"]["chips"]
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, {torch.cuda.device_count()} are present",
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measured process: {bad}", file=sys.stderr)
        return 3
    print(f"card: {card_note(torch.device('cuda', torch.cuda.current_device()))}",
          file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
