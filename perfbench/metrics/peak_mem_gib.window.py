"""The peak of device memory allocated inside the window alone
(``torch.cuda.max_memory_allocated`` since a reset at its first launch),
in GiB: training's own memory, where ``peak_mem_gib`` also holds set-up's
(a convolution's first call can take a transient workspace)."""


def read(ctx):
    return ctx.window_peak_bytes / 2 ** 30 if ctx.window_peak_bytes > 0 else None
