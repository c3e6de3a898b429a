"""Peak device memory of the window in GiB: torch.cuda.max_memory_allocated()
after a reset at the window's start, on the fullest card."""


def read(ctx):
    if not ctx.window_peak_bytes:
        return None
    return ctx.window_peak_bytes / 2.0 ** 30
