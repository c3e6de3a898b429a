"""Observability: structured render metrics, spans on torch.profiler's
trace, process-wide totals of rare events, and a NaN-debug mode (port of
rust_raytracer_tpu/utils/metrics.py).

The reference prints per-thread wall-clock only (camera.rs:235-236); here a
render records throughput counters a script can scrape, and the program
marks where its host work happens:

- `span(name)` opens a `torch.profiler.record_function("rrt." + name)`
  while the profiler records, so the span lands in the same trace as the
  card's kernels and copies, on the same clock.  With the profiler off it
  reads one flag and does nothing else: no synchronize, no tensor, no
  counter.  Spans are never entered inside a stream capture's body.
- `timed(name)` is a span that also adds its event's count and seconds to
  process-wide totals (`totals()`), always on: for rare events (a graph
  capture, a scene compile), a few a process.

Otherwise opt-in: no global state is touched unless a context manager is
entered.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class RenderMetrics:
    """Accumulates counters during a render; emit() prints ONE JSON line
    so logs stay machine-parseable.  The pool renderer (render/pool.py)
    records into it every poll."""

    n_pixels: int = 0
    spp: int = 0
    max_depth: int = 0
    samples_issued: int = 0
    steps: int = 0
    lane_bounces: int = 0          # lanes advanced x steps (pool work units)
    # host seconds of the render, from its start until its image is in the
    # Film on the host (the copy home synchronises); Renderer.render sets it
    render_s: float = 0.0
    bounce_alive: List[int] = field(default_factory=list)  # live lanes a poll
    # wavefront traversal capacity overflow: packets that hit a static cap
    # (and may have dropped a real hit) / all 8-lane packets traced.  emit()
    # warns when the fraction exceeds 0.1% (the reference's octree drops
    # nothing: octree.rs:63-116 visits every overlapped leaf).
    wf_overflow_packets: int = 0
    wf_total_packets: int = 0
    # free-flight scattering events in volumes, of live lanes: the pool
    # step's counter (on the card the shading kernel's), read when the
    # render's loop has ended; 0 in a scene without volumes
    volume_hits: int = 0
    # lane bounces whose closest hit is a sphere, of live lanes: the pool
    # step's counter (on the card the shading kernel's), read when the
    # render's loop has ended; None in a scene without spheres
    sphere_hits: Optional[int] = None
    # the BVH8 kernel's leaf visits and the groups of 32 slots it tested
    # there (of 4 a visit): the pool step's counter, on the card, read when
    # the render's loop has ended; 0 on the CPU and for the other walks
    k1_leaf_visits: int = 0
    k1_groups_tested: int = 0
    # the vertex hit kernel's (KV1's) node visits and sphere tests in the
    # spheres' BVH, of live lanes: the pool step's counter, on the card,
    # read when the render's loop has ended; 0 on the CPU (its plain loop
    # walks no tree), None in a scene without spheres
    kv1_node_visits: Optional[int] = None
    kv1_sphere_tests: Optional[int] = None

    def record_step(self, n_alive: int, n_lanes: int, issued: int,
                    weight: int = 1):
        """Record one occupancy sample covering `weight` pool steps (the
        pool reads the device state only every steps_per_poll steps, so
        occupancy is poll-granular)."""
        self.steps += weight
        self.lane_bounces += n_alive * weight
        self.samples_issued = issued
        self.bounce_alive.append(int(n_alive))

    def summary(self) -> dict:
        """The counters, and the rates over the render's own seconds
        (`render_s`; None before a render has set it)."""
        total = self.n_pixels * self.spp
        occ = float(np.mean(self.bounce_alive)) if self.bounce_alive else 0.0
        wall = self.render_s or None
        out = {
            "pixel_samples": total,
            "samples_issued": self.samples_issued,
            "pixel_samples_per_s": self.samples_issued / wall if wall else None,
            # 1 closest-hit per lane-bounce
            "rays_per_s": self.lane_bounces / wall if wall else None,
            "steps": self.steps,
            "mean_occupancy": occ,
            "wall_s": wall,
        }
        if self.volume_hits:
            out["volume_hits"] = self.volume_hits
        if self.sphere_hits is not None:
            out["sphere_hits"] = self.sphere_hits
        if self.k1_leaf_visits:
            out["k1_leaf_visits"] = self.k1_leaf_visits
            out["k1_groups_tested"] = self.k1_groups_tested
        if self.kv1_node_visits is not None:
            out["kv1_node_visits"] = self.kv1_node_visits
            out["kv1_sphere_tests"] = self.kv1_sphere_tests
        if self.wf_total_packets:
            out["wf_overflow_packets"] = self.wf_overflow_packets
            out["wf_overflow_frac"] = self.wf_overflow_packets / self.wf_total_packets
        return out

    def emit(self, stream=None) -> str:
        """Print the JSON line to `stream` (default stdout) and return it.
        The overflow warning goes to stderr, so the JSON line's stream holds
        nothing else."""
        s = self.summary()
        if s.get("wf_overflow_frac", 0.0) > 1e-3:
            print(
                "WARNING: wavefront traversal overflowed its candidate "
                f"capacity on {s['wf_overflow_packets']} packets "
                f"({s['wf_overflow_frac']:.2%}) — hits may be dropped; "
                "use kernel='bvh8' (exact BVH8) to verify",
                file=sys.stderr,
            )
        line = json.dumps({"render_metrics": s})
        print(line, file=stream)
        return line


class span:
    """`with span(name, unit):` marks the block as `rrt.<name>` on
    torch.profiler's trace while the profiler records
    (`torch.autograd._profiler_enabled()`); `unit`, the index of the render
    or step the block belongs to, is passed as the record_function's
    `args` (an enclosed span without one takes its enclosing span's).
    Otherwise it only reads that flag."""
    __slots__ = ("name", "unit", "_record")
    _units: List[Optional[str]] = []   # the open spans' units, while profiling

    def __init__(self, name: str, unit=None):
        self.name, self.unit, self._record = name, unit, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            units = span._units
            unit = str(self.unit) if self.unit is not None else (units[-1] if units else None)
            units.append(unit)
            self._record = torch.profiler.record_function("rrt." + self.name, unit)
            self._record.__enter__()
        return self

    def __exit__(self, *exc):
        if self._record is not None:
            self._record.__exit__(*exc)
            self._record = None
            span._units.pop()
        return False


_totals: Dict[str, List] = {}


@contextlib.contextmanager
def timed(name: str):
    """A `span(name)` whose completed event also adds one and its host
    seconds to the process-wide totals of `name` (`totals()`), whether or
    not the profiler records.  For rare events only: graph captures and
    scene compiles."""
    t0 = time.perf_counter()
    with span(name):
        yield
    entry = _totals.setdefault(name, [0, 0.0])
    entry[0] += 1
    entry[1] += time.perf_counter() - t0


def totals() -> Dict[str, Tuple[int, float]]:
    """{name: (events, seconds)} of every `timed` event of this process:
    "graphs.capture" (GraphedStep's and GraphedGrad's warm-up and capture, a
    LoopGraph's build, each ending in a synchronize) and "scene.compile"
    (scene/compiler.py:compile_scene)."""
    return {name: (n, secs) for name, (n, secs) in _totals.items()}


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """torch.profiler over the block, CPU activity and, where CUDA is
    available, the card's; on exit a Chrome trace (`trace_<pid>_<ms>.json`,
    viewable in chrome://tracing or Perfetto) is written under log_dir.
    No-op when log_dir is None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


_nan_checks = False


def nan_checks() -> bool:
    """Whether debug_nans is on: the pool step and `integrator.trace` check
    their outputs."""
    return _nan_checks


def check_nans(where: str, **tensors):
    """Raise FloatingPointError naming the first of `tensors` that holds a
    NaN (one device read per tensor)."""
    for name, t in tensors.items():
        if t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in {name} at {where}")


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """NaN-debug mode, the counterpart of jax_debug_nans: the pool step and
    every bounce of `integrator.trace` read their float outputs back and
    raise FloatingPointError at the first that holds a NaN, so a lane that
    poisons the image is caught at the step that produced it, not in the
    final buffer.  Each check synchronizes with the device: use it for
    debugging, never for benchmarks.  Off, it adds nothing to a step."""
    global _nan_checks
    if not enable:
        yield
        return
    old = _nan_checks
    _nan_checks = True
    try:
        yield
    finally:
        _nan_checks = old
