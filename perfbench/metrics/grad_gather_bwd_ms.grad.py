"""Device ms a traced fwd+bwd step of the per-lane row gathers' backward:
the summed device time of the kernels named below over the traced steps,
a step's mean.  They are PyTorch's backward of table[idx] (index_put_ with
accumulate) and the program's hand-written one (its tile and carry
kernels), so the number reads the same work whichever the program runs;
none where the trace holds neither."""

KERNELS = ("indexing_backward_kernel", "indexing_backward_kernel_small_stride",
           "indexing_backward_kernel_stride_1", "row_gather_bwd_tile",
           "row_gather_bwd_carry")


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    secs, launches = ctx.trace.kernels(KERNELS)
    if launches == 0:
        return None
    return 1e3 * secs / len(ctx.traced_units)
