"""Device ms a traced render of the free flight: in each pool step on a
card, the device time of everything that runs after the last of the
closest-hit and walk kernels named in HIT_KERNELS and before the next
shading kernel (SHADE_KERNEL), summed over the traced renders and divided
by their number.  In the program that is the volumes' merge after the
walk (torch ops today; the rule reads the same work if a fused kernel
does it).  None without a trace or where no such stretch ran."""
from perfbench.core.devtrace import is_kernel

HIT_KERNELS = ("vertex_hit_kernel", "bvh8_traverse_kernel", "threaded_traverse_kernel",
               "wf_cull_kernel", "wf_cull_compact_kernel", "wf_compact_kernel", "wf_mt_kernel")
SHADE_KERNEL = "vertex_shade_kernel"


def stretch_seconds(trace) -> tuple:
    """(seconds, stretches) between the hit kernels and the next shading
    kernel, over every card (overlapping activity counted once)."""
    secs, n = 0.0, 0
    for ivs in trace.intervals.values():
        pending, end, open_ = 0.0, float("-inf"), False
        for a, b, sym in ivs:
            if any(is_kernel(sym, k) for k in HIT_KERNELS):
                pending, end, open_ = 0.0, b, True
            elif is_kernel(sym, SHADE_KERNEL):
                if open_:
                    secs += pending
                    n += 1
                open_ = False
            elif open_ and b > end:
                pending += b - max(a, end)
                end = b
    return secs, n


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    secs, n = stretch_seconds(ctx.trace)
    if n == 0:
        return None
    return 1e3 * secs / len(ctx.traced_units)
