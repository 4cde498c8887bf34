"""The device trace of a short slice of the timed path, and what the
per-layer metrics read from it.

``profile_slice`` runs one warm-up call and then the slice under
``torch.profiler`` (host and device activity), the slice inside a host
annotation that ends after a ``torch.cuda.synchronize()``; it exports the
Chrome trace into a temporary directory and reduces it with
``summarize``. A trace whose slice holds no device time (the card's
profiler has lost whole windows of device records) is taken again.

``summarize`` keeps the device operations (kernels, copies, sets) inside
the annotation, clipped to it, and gives: the annotation's length (the
traced window), the union of the operations' intervals (time in which an
operation ran: overlapping kernels count once), the sum of their
durations, the kernels launched, the seconds and count of each operation
by name, and the gaps between busy intervals named by the innermost host
operation that spans each gap's middle.
"""

from __future__ import annotations

import json
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

SLICE = "perfbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
ATTEMPTS = 4
NAME_CHARS = 160
GAPS = 10          # the longest gaps kept


@dataclass
class Summary:
    span_s: float                      # the traced window
    busy_s: float                      # union of device intervals
    device_s: float                    # sum of device durations
    kernels: int                       # kernels launched
    by_name: Dict[str, List[float]] = field(default_factory=dict)   # name -> [count, s]
    gaps: List[Tuple[str, float]] = field(default_factory=list)      # the GAPS longest
    steps: int = 0                     # outer steps in the slice

    def seconds_of(self, word: str) -> float:
        """Device seconds of the operations whose name holds ``word``."""
        return sum(s for name, (_, s) in self.by_name.items() if word in name)

    def top_ops(self, n: int = 10) -> List[List]:
        return [[k, v[1]] for k, v in sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:n]]


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: List[dict], steps: int) -> Optional[Summary]:
    """The slice's summary from Chrome trace events (times in µs), or
    ``None`` where the trace holds no slice annotation."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    ops, by_name, kernels = [], {}, 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), t0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), t1)
        if b <= a:
            continue
        ops.append((a, b))
        name = str(e.get("name", "?"))[:NAME_CHARS]
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (b - a) * 1e-6
        kernels += e["cat"] == "kernel"
    busy = _merge(ops)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    longest = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                     key=lambda ab: ab[0] - ab[1])[:GAPS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("name") != SLICE]
    gaps = []
    for a, b in longest:
        mid = 0.5 * (a + b)
        spanning = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        name = min(spanning, key=lambda e: float(e["dur"]))["name"] if spanning else "no host op"
        gaps.append((str(name)[:NAME_CHARS], (b - a) * 1e-6))
    return Summary(span_s=(t1 - t0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                   device_s=sum(v[1] for v in by_name.values()), kernels=kernels,
                   by_name=by_name, gaps=gaps, steps=steps)


def profile_slice(warm: Callable[[], None], run: Callable[[], None],
                  steps: int) -> Optional[Summary]:
    """Trace ``warm()`` and then ``run()`` (``steps`` outer steps) as the
    slice; again where the slice holds no device time. ``None`` where no
    attempt held any."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(ATTEMPTS):
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                warm()
                torch.cuda.synchronize()
                with record_function(SLICE):
                    run()
                    torch.cuda.synchronize()
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
        summary = summarize(events, steps)
        if summary is not None and summary.busy_s > 0:
            return summary
    return None
