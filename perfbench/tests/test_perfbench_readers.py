"""The metric readers: the K1 byte rule on a tiny scene, the idle share and
the kernel matching of the device trace."""
import types

import pytest

from perfbench.core import devtrace, peaks, spec
from perfbench.core.workload import Unit


def _ctx(units, traced=None, trace=None, loop="renders", **sizes):
    return types.SimpleNamespace(units=units, traced_units=traced or [], trace=trace,
                                 window_s=1.0, setup_s=1.0, window_peak_bytes=0,
                                 sizes=sizes, cell=types.SimpleNamespace(traffic={"loop": loop}))


def _trace(kernels_s, names, window=1.0):
    ivs, t = [], 0.0
    for name, secs in zip(names, kernels_s):
        ivs.append((t, t + secs, name + "(float const*)"))
        t += secs
    return devtrace.DeviceTrace(window_s=window, intervals={0: ivs}, host=[], devices=(0,))


def test_k1_byte_rule():
    """Bytes: 36 a traced ray (live lanes of every step) and 36 a triangle a
    launch, over the HBM bandwidth, against the walk kernels' time."""
    read = spec.metric_reader("k1_roofline_pct.render")
    counters = types.SimpleNamespace(lane_bounces=1000, bounce_alive=[100], steps=10)
    trace = _trace([1e-3, 1e-3, 5e-4], ["bvh8_traverse_kernel", "bvh8_traverse_kernel",
                                        "vertex_shade_kernel"])
    ctx = _ctx([], [Unit(0, 1, 64, True, counters)], trace, loop="renders",
               triangles=10, lanes=128)
    want = 100 * ((1000 * 36 + 2 * 10 * 36) / peaks.HBM_BYTES_PER_S) / 2e-3
    assert read(ctx) == pytest.approx(want)
    assert read(_ctx([], [], None)) is None


def test_idle_and_kernel_matching():
    trace = devtrace.DeviceTrace(window_s=2.0, intervals={0: [(0.0, 0.5, "a_kernel"),
                                                             (0.25, 1.0, "wf_cull_kernel"),
                                                             (1.5, 1.75, "Memcpy DtoH")],
                                                         1: [(0.0, 2.0, "b")]},
                                 host=[(1.0, 1.5, "cudaStreamSynchronize")], devices=(0, 1))
    assert trace.busy_s(0) == pytest.approx(1.25)
    assert trace.idle_pct(0) == pytest.approx(37.5)
    assert spec.metric_reader("device_idle_pct.render")(
        types.SimpleNamespace(trace=trace)) == pytest.approx((37.5 + 0.0) / 2)
    assert spec.metric_reader("mesh_idle_max_pct.render")(
        types.SimpleNamespace(trace=trace)) == pytest.approx(37.5)
    assert trace.kernels(["wf_cull_kernel"]) == (pytest.approx(0.75), 1)
    assert trace.kernels(["wf_cull_compact_kernel"]) == (0.0, 0)
    assert trace.kernel_count() == 3
    assert trace.idle_gaps(1) == [["cudaStreamSynchronize", pytest.approx(0.5)]]


def test_scene_triangles_of_the_mini_dragon(monkeypatch):
    """The triangle count the K1 rule reads is the scene's, without the
    BVH's padding: 2 x rings x segments of the knot."""
    from perfbench.core.workload import Runner
    from perfbench.tests.small import KNOT, small_cell

    cell = small_cell("dragon_render", monkeypatch)
    d = Runner(cell, 3, "cpu")
    assert d.scene_triangles() == 2 * KNOT["rings"] * KNOT["segments"]
