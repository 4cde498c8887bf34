"""Device milliseconds an outer step in its draws, by the port's
``step.datagen`` span (``perfbench/span_pass.py``): the batch, from
whichever datagen route the cell takes, and the penalty's uniforms.
Nothing where the port has no such span."""

from perfbench import span_pass

SPAN = "step.datagen"


def read(ctx):
    r = span_pass.result(ctx)
    return r["device"].get(SPAN) if r else None
