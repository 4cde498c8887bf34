"""Seconds from the process's start to the window's first launch: imports,
kernel build or cache hit, weights, the checked steps, warm-up, capture and
the rate probe (host clock)."""


def read(ctx):
    return ctx.setup_s
