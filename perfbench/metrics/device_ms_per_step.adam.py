"""Device milliseconds an outer step in Adam's updates of both nets, by the
port's ``optim`` spans (``perfbench/span_pass.py``): n_critic updates of
the critic and one of the generator. Nothing where the port has no such
span."""

from perfbench import span_pass

SPAN = "optim"


def read(ctx):
    r = span_pass.result(ctx)
    return r["device"].get(SPAN) if r else None
