"""What the metric readers of the program's own spans and counters share
(rust_raytracer_torch/utils/metrics.py: `span`, `timed`, `totals`).

The program marks its host work on the profiler's trace as `rrt.<name>`
events, which the traced window's DeviceTrace holds among its host events
(perfbench/core/devtrace.py); its rare events (graph captures, scene
compiles) it adds to process-wide totals, set-up included.  A program
without them (an older checkout) gives nothing to read: the readers then
return None."""
from __future__ import annotations

from typing import Optional

from perfbench.core.devtrace import _merged


def idle_under_pct(trace, span: str) -> Optional[float]:
    """The share of the traced window, in %, in which a card idles while the
    host is inside span `rrt.<span>`, mean over the cards: on each card the
    window less the union of its device activity (device_idle_pct's
    arithmetic), intersected with the union of the span's events clipped to
    the window.  None without a trace or without such an event."""
    if trace is None:
        return None
    name = "rrt." + span
    under = _merged((max(a, 0.0), min(b, trace.window_s)) for a, b, n in trace.host
                    if n == name and min(b, trace.window_s) > max(a, 0.0))
    if not under:
        return None
    total = 0.0
    for d in trace.devices:
        t, idle = 0.0, []
        for a, b in _merged(trace.intervals.get(d, [])) + [(trace.window_s, trace.window_s)]:
            if a > t:
                idle.append((t, a))
            t = max(t, b)
        total += _overlap(idle, under)
    return 100.0 * total / len(trace.devices) / trace.window_s


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def total_seconds(name: str) -> Optional[float]:
    """The seconds of the program's `timed` events `name` in this process
    (utils/metrics.totals()), or None where it has none or no totals."""
    from rust_raytracer_torch.utils import metrics

    totals = getattr(metrics, "totals", None)
    if totals is None or name not in totals():
        return None
    return totals()[name][1]
