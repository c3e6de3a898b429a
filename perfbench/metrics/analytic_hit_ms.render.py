"""Device ms a traced render of the closest sphere and plane hit (KV1,
`vertex_hit_kernel`, one launch a pool step): its summed device time in
the traced window over the traced renders.  None without a trace or where
it did not run."""

KERNELS = ("vertex_hit_kernel",)


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    secs, launches = ctx.trace.kernels(KERNELS)
    if launches == 0:
        return None
    return 1e3 * secs / len(ctx.traced_units)
