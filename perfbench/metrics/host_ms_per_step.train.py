"""Host milliseconds an outer step in the chunk's call, by the port's
``chunk`` span (``perfbench/span_pass.py``): an eager chunk's enqueue of
its steps (stretched to the device's pace once the launch queue is full),
or a graphed chunk's replay call, over the chunk's outer steps. Nothing
where the port has no such span."""

from perfbench import span_pass


def read(ctx):
    r = span_pass.result(ctx)
    return r["host_ms_per_step"] if r and r["host_ms_per_step"] > 0 else None
