"""Device milliseconds an outer step: the summed durations of the slice's
device operations over its outer steps."""


def read(ctx):
    t = ctx.trace
    if t is None or t.device_s <= 0 or t.steps <= 0:
        return None
    return 1e3 * t.device_s / t.steps
