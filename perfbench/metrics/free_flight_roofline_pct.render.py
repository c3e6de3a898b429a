"""The free flight's share of its roofline, in %: the least time its
bytes need at the HBM bandwidth, over its device time
(free_flight_ms.render's stretches) in the traced window.

The bytes are counted from the lanes, not from the implementation, so
they read the same work whatever does the free flight: for each live
lane of every traced step (readers.lane_vertices), its ray (origin and
direction, 24 B), the nearest surface's t (4 B) and its RNG key (pixel,
sample and bounce as the pool stores them, 3 x 8 B) read once, and its t
and volume id (8 B) written once: 60 B a lane."""
from pathlib import Path

from perfbench.core import spec
from perfbench.core.readers import lane_vertices
from perfbench.core.peaks import HBM_BYTES_PER_S

LANE_BYTES = 24 + 4 + 24 + 8

_flight = spec.load_module(Path(__file__).with_name("free_flight_ms.render.py"),
                           "perfbench_metric_free_flight_ms_render")


def read(ctx):
    lanes = lane_vertices(ctx)
    if lanes is None or ctx.trace is None:
        return None
    secs, n = _flight.stretch_seconds(ctx.trace)
    if n == 0 or secs <= 0.0:
        return None
    return 100.0 * (lanes * LANE_BYTES / HBM_BYTES_PER_S) / secs
