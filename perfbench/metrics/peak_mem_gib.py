"""The peak of device memory allocated over set-up and window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(ctx):
    return ctx.memory_peak_bytes / 2 ** 30 if ctx.memory_peak_bytes > 0 else None
