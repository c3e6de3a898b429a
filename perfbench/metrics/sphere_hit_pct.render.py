"""Lane bounces whose closest hit is a sphere, in %, over the traced
renders: RenderMetrics.sphere_hits (the live lanes whose closest hit is a
sphere, counted on the card by the shading kernel, one atomic a warp, and
read when the render's pool loop has ended) over
RenderMetrics.lane_bounces (poll-granular, readers.lane_vertices).  None
where the program has no such counter or the scene has no sphere (the
counter is then None)."""
from perfbench.core.readers import lane_vertices


def read(ctx):
    counters = [u.counters for u in ctx.traced_units
                if getattr(u.counters, "sphere_hits", None) is not None]
    lanes = lane_vertices(ctx)
    if not counters or not lanes:
        return None
    return 100.0 * sum(c.sphere_hits for c in counters) / lanes
