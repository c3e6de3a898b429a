"""Sphere tests a lane bounce of the closest-sphere search (KV1, the walk
of the spheres' BVH), over the traced renders: RenderMetrics.kv1_sphere_tests
(the live lanes' sphere tests, counted on the card by the kernel, one
atomic a warp, and read when the render's pool loop has ended) over
RenderMetrics.lane_bounces (poll-granular, readers.lane_vertices).  A loop
over every sphere would read the scene's sphere count.  None where the
program has no such counter, the scene has no sphere (the counter is then
None) or nothing was counted."""
from perfbench.core.readers import lane_vertices


def read(ctx):
    counters = [u.counters for u in ctx.traced_units
                if getattr(u.counters, "kv1_sphere_tests", None) is not None]
    lanes = lane_vertices(ctx)
    tests = sum(c.kv1_sphere_tests for c in counters)
    if not tests or not lanes:
        return None
    return tests / lanes
