"""The shading kernel's share of its roofline, in %: the least time its
bytes need at the HBM bandwidth, over the summed device time of KV2
(`vertex_shade_kernel`) in the traced window.

The bytes are counted from the lanes, not from the kernel, so they read
the same work whatever implements the shading: for each live lane of
every traced step (readers.lane_vertices), its ray (24 B), its RNG key
(pixel, sample and bounce as the pool stores them, 24 B) and its closest
hit as one (t, kind, primitive) (12 B) read once, and its emission,
weight, next direction and position (48 B) and ended flag (1 B) written
once: 109 B a lane.  KV2 reads the three hits apart where no volume merged
them (12 B more a lane, csrc/vertex_shade.cu's ~121 B) and the scene's
rows and texture closures from cache; counting the least a lane needs
keeps the share under 100% in every scene."""
from perfbench.core.readers import lane_vertices, roofline_pct

KERNELS = ("vertex_shade_kernel",)
LANE_BYTES = 24 + 24 + 12 + 48 + 1


def read(ctx):
    lanes = lane_vertices(ctx)
    if lanes is None or ctx.trace is None:
        return None
    return roofline_pct(ctx, KERNELS, lanes * LANE_BYTES)
