"""The window's share of the card's float32 peak, in %: the model FLOP of
an outer step from the configuration's shapes (``counts.step_flops``: a
backward twice its forward, no recomputation) times the window's outer
steps, over the window's seconds, over 67 TFLOP/s."""


def read(ctx):
    c = ctx.counts
    flops = c.step_flops(ctx.config, ctx.cell["batch"], ctx.cell["recipe"]["n_critic"])
    return 100.0 * flops * ctx.window["steps"] / ctx.window["seconds"] / c.FP32_FLOPS_PER_S
