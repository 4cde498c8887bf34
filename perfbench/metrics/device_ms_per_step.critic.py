"""Device milliseconds an outer step in the critic updates, by the port's
``step.critic`` spans (``perfbench/span_pass.py``): each update's span
less its Adam update's (``optim``), summed over the step's updates. On
either route: the generator's forward without gradient, the critic's loss
and gradient (the critic kernel, or autograd with the second-order
penalty). Nothing where the port has no such span."""

from perfbench import span_pass

SPAN = "step.critic"


def read(ctx):
    r = span_pass.result(ctx)
    return r["device"].get(SPAN) if r else None
