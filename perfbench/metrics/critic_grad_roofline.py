"""The critic-gradient kernel's share of its roofline, in %: the least time
of one call at the cell's batch (``counts.critic_bound_ms``, bound by its
operations) over the device time a call of the kernels whose names hold
``critic_grad``, a call a critic update. Nothing where the slice holds no
such kernel."""

WORD = "critic_grad"


def read(ctx):
    t = ctx.trace
    if t is None or t.steps <= 0:
        return None
    seconds = t.seconds_of(WORD)
    if seconds <= 0:
        return None
    calls = t.steps * ctx.cell["recipe"]["n_critic"]
    bound_ms, _ = ctx.counts.critic_bound_ms(ctx.cell["batch"])
    return 100.0 * bound_ms / (1e3 * seconds / calls)
