"""The span pass of a traced run: the port's own spans
(``ofdmgan_tpu_torch/utils/spans.py``) over a few chunks of the cell's
kind, for the metrics that read them (``metrics/device_ms_per_step.*``
but ``.train``, ``host_ms_per_step.train``, ``build_s.setup``,
``capture_s.setup``).

It runs once a run, when the first of those metrics is read: after the
window, the traced slice and the comparison, so none of them sees it. It
builds the cell's program afresh on the run's device (the run's own is
freed by then; its weights and draws come from ``SEED``, as the pass times
the step and compares nothing), switches spans on, makes one warm call of
a fresh chunk (a graphed cell's eager warm-up; then its capture, taken with
spans on so that the graph holds the spans' device events, and a first
replay), then calls ``trace_chunks`` chunks, each followed by a
synchronize after which its spans are read: a replay records the
captured events again, so each replay's device times are read after it.

Readings: ``device``, each span name's self time in ms an outer step (the
span minus its child spans), averaged over the chunks (empty without a
card); ``host_ms_per_step``, the ``chunk`` span's host time over the
chunk's outer steps (the host's enqueue of a chunk, which a full launch
queue stretches to the device's pace); ``setup``, the set-up spans
(``ops.build``, ``chunk.capture``, kept with spans off) recorded before
the pass: nothing is built or captured past the window's first launch, so
these are set-up's. Where the port has no spans it gives nothing and runs
nothing.
"""

from __future__ import annotations

import importlib.util
import sys
from typing import Optional

import torch

SEED = 0x5EED
SETUP = ("ops.build", "chunk.capture")
PHASES = ("step.datagen", "step.critic", "step.generator", "optim")
STEP = "step"   # the outer step's span: its self time is what no phase covers


def result(ctx) -> Optional[dict]:
    """The pass's readings for ``ctx``'s run (see the module's docstring),
    taken at the first call; ``None`` where the port has no spans."""
    if not hasattr(ctx, "_span_pass"):
        ctx._span_pass = _run(ctx)
    return ctx._span_pass


def setup_seconds(ctx, name: str) -> Optional[float]:
    """Host seconds of set-up's ``name`` spans, summed; ``None`` where set-up
    recorded none."""
    r = result(ctx)
    recs = [x for x in (r["setup"] if r else []) if x.name == name]
    return sum(x.host_ms for x in recs) * 1e-3 if recs else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(ctx) -> Optional[dict]:
    if importlib.util.find_spec("ofdmgan_tpu_torch.utils.spans") is None:
        return None
    from ofdmgan_tpu_torch.utils import spans

    from .program import Program, make_weights

    setup = [r for r in spans.records() if r.name in SETUP]
    # a run on the card reads a peak of device memory, one on the CPU none
    device = (torch.device("cuda", torch.cuda.current_device()) if ctx.memory_peak_bytes > 0
              else torch.device("cpu"))
    program = Program(ctx.config, ctx.cell, make_weights(ctx.config, SEED, device), SEED, device)
    chunk = program.make_chunk()
    readings, host = [], []
    spans.enable()
    try:
        chunk()
        start = len(spans.records())
        if program.graphed:
            chunk()
        _sync(device)
        captured = [r for r in spans.records()[start:] if r.step is not None]
        for _ in range(ctx.cell["trace_chunks"]):
            first = len(spans.records())
            chunk()
            _sync(device)
            new = spans.records()[first:]
            readings.append(spans.per_step_ms(captured if program.graphed else new))
            host.append(sum(r.host_ms for r in new if r.name == "chunk")
                        / program.steps_per_chunk)
    finally:
        spans.disable()
        del program, chunk
        if device.type == "cuda":
            torch.cuda.empty_cache()
    names = set().union(*readings)
    device_ms = {n: sum(x.get(n, 0.0) for x in readings) / len(readings) for n in names}
    out = {"device": device_ms, "host_ms_per_step": sum(host) / len(host), "setup": setup}
    _report(ctx, out)
    return out


def _report(ctx, out: dict) -> None:
    """The pass's readings on standard error, with the coverage of the
    slice's device time by the step's spans."""
    ms = out["device"]
    parts = ", ".join(f"{n} {ms[n]:.4f}" for n in (*PHASES, STEP) if n in ms)
    line = f"span pass, ms an outer step: {parts}; host {out['host_ms_per_step']:.4f}"
    t = ctx.trace
    if ms and t is not None and t.steps > 0 and t.device_s > 0:
        total = sum(ms.get(n, 0.0) for n in (*PHASES, STEP))
        line += (f"; phases and step self {total:.4f} over the slice's device ms "
                 f"{1e3 * t.device_s / t.steps:.4f}")
    print(line, file=sys.stderr)

