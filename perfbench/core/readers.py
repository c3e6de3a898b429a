"""Arithmetic that several metric readers share: what each reads from the
traced window (perfbench/core/devtrace.py) and from the program's render
counters (rust_raytracer_torch/utils/metrics.py:RenderMetrics, one a
render)."""
from __future__ import annotations

from typing import Optional

from perfbench.core import peaks


def mean_idle_pct(ctx) -> Optional[float]:
    """Idle share of the traced window, mean over the cards used: 1 - (union
    of device activity) / window wall, in %."""
    if ctx.trace is None:
        return None
    t = ctx.trace
    return sum(t.idle_pct(d) for d in t.devices) / len(t.devices)


def lane_vertices(ctx) -> Optional[int]:
    """Live lanes summed over the pool steps of the traced units: each
    poll's live lanes weighted by the steps of the poll (the pool reads its
    lanes once a poll)."""
    counters = [u.counters for u in ctx.traced_units if hasattr(u.counters, "lane_bounces")]
    if not counters:
        return None
    return sum(c.lane_bounces for c in counters)


def roofline_pct(ctx, kernels, nbytes: float) -> Optional[float]:
    """Share of the bound, in %: `nbytes` over the HBM bandwidth, against
    the summed device time of `kernels` in the traced window."""
    if ctx.trace is None:
        return None
    secs, launches = ctx.trace.kernels(kernels)
    if launches == 0 or secs <= 0.0:
        return None
    return 100.0 * (nbytes / peaks.HBM_BYTES_PER_S) / secs
