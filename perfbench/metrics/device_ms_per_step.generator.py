"""Device milliseconds an outer step in the generator update, by the port's
``step.generator`` span (``perfbench/span_pass.py``) less its Adam update's
(``optim``): the generator's loss (its forward and the critic's score),
its gradient and, where the step is sharded, the gradients' reduce.
Nothing where the port has no such span."""

from perfbench import span_pass

SPAN = "step.generator"


def read(ctx):
    r = span_pass.result(ctx)
    return r["device"].get(SPAN) if r else None
