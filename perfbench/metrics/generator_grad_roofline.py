"""The generator-gradient kernel's share of its roofline, in %: the least time
of one call at the cell's batch (``bound_ms``, bound by its operations)
over the device time a call of the kernels whose names hold
``generator_grad``, a call an outer step (the generator's update). Nothing
where the slice holds no such kernel.

The bound: the multiply-adds of the mini generator's update counting only
the conv taps that fall inside a 16-sample frame (``macs_per_frame``: the
generator's forward, its weight gradient, its data gradient below ``enc1``,
the mini critic's forward and its gradient back to the candidate frame),
at 67 TFLOP/s, against the bytes (``noisy`` and ``clean`` read once, both nets'
parameters read once, a gradient a generator parameter and three metrics
written once) at 3.35 TB/s, whichever is larger."""

WORD = "generator_grad"
L = 16
# (input length, stride, in channels, out channels) of each layer, at L = 16
GENERATOR = ((L, 2, 2, 4), (L // 2, 2, 4, 8), (L // 2, 1, 8, 4), (L, 1, 4, 2))  # enc1 .. out_conv
CRITIC = ((L, 2, 4, 8), (L // 2, 2, 8, 16))   # conv1 reads (fake, noisy): 2 + 2 channels
FAKE_CHANNELS = 2
GENERATOR_PARAMS, CRITIC_PARAMS, METRICS = 258, 521, 3


def taps_inside(l_in: int, stride: int, k: int = 3, pad: int = 1) -> int:
    """Conv taps that fall inside a frame of ``l_in`` samples."""
    l_out = (l_in + 2 * pad - k) // stride + 1
    return sum(1 for t in range(l_out) for kk in range(k) if 0 <= stride * t - pad + kk < l_in)


def macs_per_frame() -> int:
    """Multiply-adds a frame of one generator update: the generator's forward
    and weight gradient (each every layer's taps), its data gradient below
    ``enc1`` (every layer's but ``enc1``'s), the critic's forward (its two
    layers' taps and the dense layer's 16) and its gradient back to the
    candidate frame (the same, but ``conv1`` transposed into the candidate's
    2 input channels alone, not ``noisy``'s)."""
    gen = [taps_inside(l_in, s) * ci * co for l_in, s, ci, co in GENERATOR]
    conv1, conv2 = (taps_inside(l_in, s) * ci * co for l_in, s, ci, co in CRITIC)
    critic_fwd = conv1 + conv2 + 16
    critic_bwd = conv1 * FAKE_CHANNELS // CRITIC[0][2] + conv2 + 16
    return 2 * sum(gen) + sum(gen[1:]) + critic_fwd + critic_bwd


def bound_ms(batch: int, flops_per_s: float = 67e12, bytes_per_s: float = 3.35e12):
    """``(ms, "operations" or "bytes")``: the least time of one call."""
    t_ops = batch * 2 * macs_per_frame() / flops_per_s * 1e3
    n_bytes = batch * 2 * L * 2 * 4 + (GENERATOR_PARAMS + CRITIC_PARAMS) * 4 \
        + (GENERATOR_PARAMS + METRICS) * 4
    t_bytes = n_bytes / bytes_per_s * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def read(ctx):
    t = ctx.trace
    if t is None or t.steps <= 0:
        return None
    seconds = t.seconds_of(WORD)
    if seconds <= 0:
        return None
    c = ctx.counts
    ms, _ = bound_ms(ctx.cell["batch"], c.FP32_FLOPS_PER_S, c.HBM_BYTES_PER_S)
    return 100.0 * ms / (1e3 * seconds / t.steps)
