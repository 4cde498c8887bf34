"""Spans: named, nested intervals of the port's own work, read by the
benchmark's per-layer metrics (``perfbench/span_pass.py``) and written by
the trainer's ``--profile`` (``spans.json``).

Spans are off by default, and ``span(name)`` then returns one shared no-op
context (``NULL``): no allocation, no profiler range, no record. After
``enable()`` each span keeps a ``Record``: its name, the span it opened in
(``parent``), the outer step it belongs to (``step``: the id of the
innermost open ``step`` span, shared by every span of one outer step), its
host start and end (``time.perf_counter_ns``) and, once CUDA is in use, a
pair of timing events recorded on the current stream at its start and
end. The events are external, so a span inside a CUDA graph's capture
becomes two event nodes of the graph, which every replay records again:
after a replay and a synchronize, ``Record.device_ms`` reads that replay's
times. While on, each span also enters
``torch.profiler.record_function(name)``, so a profiler trace shows the
span on the timeline of the kernels it launched.

``host_span(name)`` is a span with no events (host time alone), and
``setup_span(name)`` one for work done once per process or per capture (a
kernel library's build, a graph's capture): it keeps its host-only record
whether spans are on or off.

Records stay in memory until ``records()`` hands them out or ``reset()``
drops them. ``per_step_ms`` reduces them to each name's self time (its
span minus the time its child spans cover) an outer step.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch

STEP = "step"
NULL = contextlib.nullcontext()


@dataclass
class Record:
    id: int
    name: str
    parent: Optional[int]
    step: Optional[int]
    host_start_ns: int
    host_end_ns: int = 0
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's two events on the device (after
        they completed), ``None`` for a span without events."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])


_on = False
_records: List[Record] = []
_open: List[Record] = []
_ids = itertools.count()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def records() -> List[Record]:
    """The records kept so far, oldest first."""
    return list(_records)


def reset() -> None:
    """Drop every record kept so far."""
    _records.clear()


def _event() -> torch.cuda.Event:
    event = torch.cuda.Event(enable_timing=True, external=True)
    event.record()
    return event


@contextlib.contextmanager
def _span(name: str, device: bool, profile: bool) -> Iterator[Record]:
    parent = _open[-1] if _open else None
    rec = Record(next(_ids), name, parent and parent.id, parent and parent.step,
                 time.perf_counter_ns())
    if name == STEP:
        rec.step = rec.id
    _records.append(rec)
    _open.append(rec)
    ranged = torch.profiler.record_function(name) if profile else NULL
    try:
        with ranged:
            start = _event() if device and torch.cuda.is_initialized() else None
            yield rec
            if start is not None:
                rec.events = (start, _event())
    finally:
        rec.host_end_ns = time.perf_counter_ns()
        _open.pop()


def span(name: str):
    """A span of ``name`` with device events where CUDA is in use (see the
    module's docstring); ``NULL`` while spans are off."""
    return _span(name, True, True) if _on else NULL


def host_span(name: str):
    """A span of ``name`` timed on the host alone; ``NULL`` while spans are off."""
    return _span(name, False, True) if _on else NULL


def setup_span(name: str):
    """A host-only span of ``name`` recorded whether spans are on or off."""
    return _span(name, False, _on)


def step():
    """The outer step's span, unless one is open already (a step's ``run``
    inside its own call)."""
    if not _on or any(r.name == STEP for r in _open):
        return NULL
    return _span(STEP, True, True)


def per_step_ms(recs: List[Record], device: bool = True) -> Dict[str, float]:
    """Each name's self time in ``recs``, summed over its records and
    divided by the outer steps they hold: ``device`` reads the spans'
    events (a span without them is left out), else the host clock. Empty
    where ``recs`` hold no outer step."""
    ms = {r.id: r.device_ms if device else r.host_ms for r in recs}
    children: Dict[int, float] = {}
    for r in recs:
        if r.parent is not None and ms[r.id] is not None:
            children[r.parent] = children.get(r.parent, 0.0) + ms[r.id]
    steps = len({r.step for r in recs if r.step is not None})
    out: Dict[str, float] = {}
    for r in recs:
        if ms[r.id] is not None and steps:
            out[r.name] = out.get(r.name, 0.0) + (ms[r.id] - children.get(r.id, 0.0)) / steps
    return out
