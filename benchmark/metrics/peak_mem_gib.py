"""torch.cuda.max_memory_allocated over the window, in GiB."""


def read(ctx):
    if ctx.window_peak_bytes is None:
        return None
    return ctx.window_peak_bytes / 2.0 ** 30
