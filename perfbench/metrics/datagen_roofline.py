"""The datagen kernel's share of its roofline, in %: the least time of one
call at the cell's batch and frame length (``counts.datagen_bound_ms``,
bound by the bytes it writes) over the device time a call of the kernels
whose names hold ``datagen_kernel``, a call an outer step. Nothing where
the slice holds no such kernel."""

WORD = "datagen_kernel"


def read(ctx):
    t = ctx.trace
    if t is None or t.steps <= 0:
        return None
    seconds = t.seconds_of(WORD)
    if seconds <= 0:
        return None
    bound_ms, _ = ctx.counts.datagen_bound_ms(ctx.cell["batch"], ctx.config["frame_length"])
    return 100.0 * bound_ms / (1e3 * seconds / t.steps)
