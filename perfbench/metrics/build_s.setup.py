"""Seconds of set-up in the port's ``ops.build`` spans
(``perfbench/span_pass.py``): each CUDA library's build with nvcc where it
is missing, and its load. Nothing where the port has no such span or set-up
loaded no library."""

from perfbench import span_pass


def read(ctx):
    return span_pass.setup_seconds(ctx, "ops.build")
