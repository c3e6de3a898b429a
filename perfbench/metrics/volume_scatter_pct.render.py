"""Scattering events in the volumes over the lanes advanced, in %, over
the traced renders: RenderMetrics.volume_hits (the free flight's events of
live lanes, counted on the card by the shading kernel and read when the
render's pool loop has ended) over RenderMetrics.lane_bounces.
lane_bounces is poll-granular (each poll's live lanes times the steps of
the poll), volume_hits exact; None where the program has no such
counter."""
from perfbench.core.readers import lane_vertices


def read(ctx):
    counters = [u.counters for u in ctx.traced_units if hasattr(u.counters, "volume_hits")]
    lanes = lane_vertices(ctx)
    if not counters or not lanes:
        return None
    return 100.0 * sum(c.volume_hits for c in counters) / lanes
