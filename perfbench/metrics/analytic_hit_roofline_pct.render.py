"""The closest sphere and plane hit's share of its roofline, in %: the
least time its bytes need at the HBM bandwidth, over the summed device
time of KV1 (`vertex_hit_kernel`) in the traced window.

The bytes are counted from the lanes, not from the spheres and planes, so
they read the same work whatever implements the search (a loop over every
sphere, or a sphere BVH): for each live lane of every traced step
(readers.lane_vertices), its ray (origin and direction, 24 B) and its
alive flag (1 B) read once, and the nearest sphere's and plane's (t, id)
(16 B) and the walk's t_max (4 B) written once: 45 B a lane.  The scene's
rows are left out (a few KB, read from cache), so the share cannot pass
100% however the search is done."""
from perfbench.core.readers import lane_vertices, roofline_pct

KERNELS = ("vertex_hit_kernel",)
LANE_BYTES = 24 + 1 + 16 + 4


def read(ctx):
    lanes = lane_vertices(ctx)
    if lanes is None or ctx.trace is None:
        return None
    return roofline_pct(ctx, KERNELS, lanes * LANE_BYTES)
