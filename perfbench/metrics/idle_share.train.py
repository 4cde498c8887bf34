"""The device's idle share of the traced slice, in %: one minus the union
of the device operations' intervals over the slice's span."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or t.span_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)
