"""The triangle walk's share of its roofline, in %: the least time the
walk's bytes need at the HBM bandwidth, over the summed device time of the
walk kernels named below in the traced window.

The bytes are counted from the lanes and the scene, not from the kernel's
counters or the BVH's layout, so they read the same work whatever
implements the walk: each traced ray's origin, direction and t_max read
once (28 B) and its t and primitive written once (8 B), the rays being the
pool's live lanes of every step; and the scene's triangle vertices (36 B a
triangle) read once a launch."""
from perfbench.core.readers import lane_vertices, roofline_pct

KERNELS = ("bvh8_traverse_kernel", "threaded_traverse_kernel")
RAY_BYTES = 28 + 8
TRIANGLE_BYTES = 36


def read(ctx):
    rays = lane_vertices(ctx)
    if rays is None or ctx.trace is None:
        return None
    _, launches = ctx.trace.kernels(KERNELS)
    nbytes = rays * RAY_BYTES + launches * ctx.sizes["triangles"] * TRIANGLE_BYTES
    return roofline_pct(ctx, KERNELS, nbytes)
