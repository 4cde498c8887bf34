"""Seconds of set-up in the port's ``chunk.capture`` spans
(``perfbench/span_pass.py``): the capture of the window's CUDA graph.
Nothing where the port has no such span or set-up captured no graph."""

from perfbench import span_pass


def read(ctx):
    return span_pass.setup_seconds(ctx, "chunk.capture")
