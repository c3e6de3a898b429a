"""The port's spans and counters (rust_raytracer_torch/utils/metrics.py:
span, timed, totals), the render's own rate, and the benchmark's readers
of them (perfbench/metrics/*, perfbench/core/program_spans.py), on the CPU.

- A pool render under torch.profiler yields the `rrt.*` spans nested as the
  program places them, each carrying its render's index as its unit.
- With the profiler off no record_function is entered, in a render, a grad
  step or a compile.
- Graph captures (through a stand-in capture, as tests/test_torch_graph.py
  and tests/test_torch_grad_graph.py use) and scene compiles advance the
  process-wide totals.
- RenderMetrics' rate is over the render's own seconds.
- Each reader's arithmetic on a hand-built DeviceTrace.
- Every program callable the benchmark wraps by name
  (perfbench/core/spans.py) resolves, is wrapped and is restored.
"""
import importlib
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.core import spans as pspans
from perfbench.core import spec
from perfbench.core.devtrace import DeviceTrace
from rust_raytracer_torch import models as tmodels
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.parallel import mesh as tmesh
from rust_raytracer_torch.render import camera as tcam
from rust_raytracer_torch.render import graphs as tgraphs
from rust_raytracer_torch.render import pool as tpool
from rust_raytracer_torch.render.renderer import Renderer
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.utils import config as tconfig
from rust_raytracer_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

LANES = 64

# the spans a pool render opens, each under its nearest enclosing span
PARENTS = {"rrt.pool.init": "rrt.render", "rrt.pool.loop": "rrt.render",
           "rrt.render.tail": "rrt.render", "rrt.graphs.replay": "rrt.pool.loop",
           "rrt.pool.poll": "rrt.pool.loop", "rrt.mesh.join": "rrt.render.tail",
           "rrt.film.to_host": "rrt.render.tail", "rrt.film.add": "rrt.render.tail"}


class DirectCapture:
    """Stands in for the CUDA capture: `replay` calls the captured body."""

    def __init__(self):
        self.count = 0

    def __call__(self, body, device):
        self.count += 1
        return types.SimpleNamespace(replay=body)


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    """The pool step through GraphedStep on the CPU, captured by
    DirectCapture."""
    capture = DirectCapture()
    monkeypatch.setattr(tgraphs, "applies",
                        lambda device, kernel, pack: tisect.resolve_kernel(kernel, pack) != "jnp")
    monkeypatch.setattr(tgraphs, "cuda_capture", capture)
    return capture


def small_renderer(shards: int = 1) -> Renderer:
    scene = tmodels.build("cornell")
    sc = tconfig.merge_scene_config(scene.config, {"output_width": 12})
    cam = tcam.camera_from_config(sc, tconfig.RenderConfig(samples_per_pixel=2, max_depth=4))
    mesh = tmesh.make_mesh(shards, device="cpu") if shards > 1 else None
    return Renderer(scene, cam, batch_size=LANES, kernel="bvh8", device="cpu", mesh=mesh)


def rrt_parent(event):
    """The nearest enclosing `rrt.*` event of `event`, or None."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("rrt."):
        p = p.cpu_parent
    return p


class SpyRecords:
    """torch.profiler.record_function that notes each (name, args) and then
    enters the real one."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = torch.profiler.record_function

        def spy(name, args=None):
            self.calls.append((name, args))
            return real(name, args)

        monkeypatch.setattr(torch.profiler, "record_function", spy)


@pytest.mark.parametrize("shards", [1, 2])
def test_render_spans_nest(graphs_on_cpu, monkeypatch, shards):
    """A graphed pool render (its graph captured by a first render) under a
    CPU profiler: every span of the table, each inside its parent, one
    `render` a render, a `graphs.replay` a shard a step, a `pool.poll` a
    poll; `mesh.join` only over shards.  Every span carries the render's
    index as its unit."""
    r = small_renderer(shards)
    r.render()
    assert graphs_on_cpu.count == shards
    spy = SpyRecords(monkeypatch)
    m = tmetrics.RenderMetrics()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render(metrics=m)
    events = [e for e in prof.events() if e.name.startswith("rrt.")]
    names = [e.name for e in events]
    want = set(PARENTS) - (set() if shards > 1 else {"rrt.mesh.join"})
    assert set(names) == want | {"rrt.render"}
    for e in events:
        parent = rrt_parent(e)
        assert (parent.name if parent else None) == PARENTS.get(e.name), e.name
    polls = len(m.bounce_alive)
    assert names.count("rrt.render") == 1 and names.count("rrt.pool.poll") == polls
    assert names.count("rrt.graphs.replay") == shards * m.steps
    assert graphs_on_cpu.count == shards  # nothing captured again
    assert len(spy.calls) == len(events)
    assert {args for _, args in spy.calls} == {str(r.renders)} and r.renders == 2


def span_target(module: str, attr: str):
    """The (owner, name) that perfbench/core/spans.py sets for `attr`
    (a module attribute or Class.method) of `module`."""
    owner = importlib.import_module(module)
    *cls, leaf = attr.split(".")
    for c in cls:
        owner = getattr(owner, c)
    return owner, leaf


def test_benchmark_span_wrappers_resolve(graphs_on_cpu):
    """Every (module, attribute) of the benchmark's SPANS resolves; inside
    layer_spans each is a wrapper of the program's own callable, and a
    graphed pool render opens the poll's, the step's, the set-up's and
    the image's spans (a poll a poll); on leaving, each is the program's
    own again."""
    own = [getattr(*span_target(m, a)) for m, a, _ in pspans.SPANS]
    r = small_renderer()
    r.render()
    metrics = tmetrics.RenderMetrics()
    with pspans.layer_spans():
        for (module, attr, _), fn in zip(pspans.SPANS, own):
            wrapped = getattr(*span_target(module, attr))
            assert wrapped is not fn and wrapped.__wrapped__ is fn, attr
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            r.render(metrics=metrics)
    names = [e.name for e in prof.events() if e.name.startswith("perfbench.")]
    assert names.count("perfbench.pool.poll") == len(metrics.bounce_alive) > 0
    assert names.count("perfbench.graphs.step") == metrics.steps
    assert {"perfbench.pool.init", "perfbench.film.to_host"} <= set(names)
    assert [getattr(*span_target(m, a)) for m, a, _ in pspans.SPANS] == own


def test_grad_replay_span_and_unit(monkeypatch):
    """A GraphedGrad replay is span `grad.replay`, its unit the replay's
    index; its capture, `graphs.capture`."""
    pack, fn = grad_case()
    step = tgraphs.GraphedGrad(fn, capture=DirectCapture())
    step(pack, torch.ones(4))
    spy = SpyRecords(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(pack, torch.ones(4))
    assert [e.name for e in prof.events() if e.name.startswith("rrt.")] == ["rrt.grad.replay"]
    assert spy.calls == [("rrt.grad.replay", "2")]


def grad_case():
    """A small scene's pack and a loss of one of its float tables."""
    pack, _ = tcompiler.compile_scene(tmodels.build("test"), "cpu")
    field = next(f for f in pack.float_fields() if float(getattr(pack, f).sum()) != 0.0)

    def fn(pack_, w):
        return (getattr(pack_, field).sum() * w).sum()
    return pack, fn


def test_profiler_off_enters_no_record_function(graphs_on_cpu, monkeypatch):
    """With the profiler off, a graphed render over two shards, its
    capture, a grad step's capture and replays and a scene compile enter
    no record_function and call no synchronize."""
    def refuse(*args, **kwargs):
        raise AssertionError("entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert not torch.autograd._profiler_enabled()
    r = small_renderer(2)
    film = r.render()
    film2 = r.render()
    assert (film.accum == film2.accum).all()
    pack, fn = grad_case()
    step = tgraphs.GraphedGrad(fn, capture=DirectCapture())
    for _ in range(3):
        loss, grads = step(pack, torch.ones(4))
    assert float(loss) != 0.0


def test_captures_advance_totals():
    """Each GraphedStep and GraphedGrad capture adds one event and its
    seconds to totals()["graphs.capture"]; a replay adds none."""
    r = small_renderer()
    n_pixels = r.camera.image_width * r.camera.image_height
    eager = tpool.make_step(r.pack, r.static, r.camera, n_pixels * 2, 2, 0, graph=False)
    capture = DirectCapture()
    graphed = tgraphs.GraphedStep(eager, capture=capture)
    before = tmetrics.totals().get("graphs.capture", (0, 0.0))
    s = graphed(r.pack, tpool.init_state(LANES, n_pixels, "cpu"))
    one = tmetrics.totals()["graphs.capture"]
    assert one[0] == before[0] + 1 and one[1] > before[1]
    graphed(r.pack, s)
    assert tmetrics.totals()["graphs.capture"] == one
    pack, fn = grad_case()
    step = tgraphs.GraphedGrad(fn, capture=capture)
    step(pack, torch.ones(4))
    step(pack, torch.ones(4))
    two = tmetrics.totals()["graphs.capture"]
    assert two[0] == one[0] + 1 and two[1] > one[1] and capture.count == 2


def test_compile_advances_totals():
    """Each compile_scene adds one event and its seconds to
    totals()["scene.compile"]; a compile that raises adds none."""
    before = tmetrics.totals().get("scene.compile", (0, 0.0))
    tcompiler.compile_scene(tmodels.build("test"), "cpu")
    after = tmetrics.totals()["scene.compile"]
    assert after[0] == before[0] + 1 and after[1] > before[1]
    with pytest.raises(TypeError):
        tcompiler.compile_scene(tmodels.build("test"), "cpu", dtype=torch.float16)
    assert tmetrics.totals()["scene.compile"] == after


def test_rate_is_over_the_render_only():
    """summary()'s rates divide by the render's own seconds (render_s), not
    by the time since the counters were made; before a render they are
    None.  The per-stage timer is gone."""
    r = small_renderer()
    n_pixels = r.camera.image_width * r.camera.image_height
    m = tmetrics.RenderMetrics(n_pixels=n_pixels, spp=r.camera.actual_spp)
    assert m.summary()["pixel_samples_per_s"] is None and m.summary()["wall_s"] is None
    r.render()   # warm: the scene's lazy tables, the step
    time.sleep(0.3)
    t0 = time.perf_counter()
    r.render(metrics=m)
    elapsed = time.perf_counter() - t0
    s = m.summary()
    assert 0.0 < m.render_s <= elapsed and s["wall_s"] == m.render_s
    assert s["pixel_samples_per_s"] == m.samples_issued / m.render_s
    assert s["rays_per_s"] == m.lane_bounces / m.render_s
    assert s["samples_issued"] == s["pixel_samples"] == n_pixels * r.camera.actual_spp
    assert not hasattr(m, "stage") and "stages_s" not in s
    assert not hasattr(m, "stage_seconds")


# ---------------------------------------------------------------- readers

def ctx_of(trace):
    return types.SimpleNamespace(trace=trace)


def read(metric, trace):
    return spec.metric_reader(metric)(ctx_of(trace))


IDLE_READERS = [("pool_loop_idle_pct.render", "pool.loop"),
                ("render_tail_idle_pct.render", "render.tail"),
                ("grad_replay_idle_pct.grad", "grad.replay")]


@pytest.mark.parametrize("metric,span", IDLE_READERS)
def test_idle_under_span_overlapping_spans_once(metric, span):
    """One card, busy [0.1, 0.3) and [0.6, 0.7) of a 1-s window; spans
    [0.2, 0.5) and [0.4, 0.65) overlap: idle under them is [0.3, 0.6), 30%."""
    trace = DeviceTrace(window_s=1.0,
                        intervals={0: [(0.1, 0.3, "k"), (0.6, 0.7, "k")]},
                        host=[(0.2, 0.5, "rrt." + span), (0.4, 0.65, "rrt." + span),
                              (0.0, 1.0, "rrt.other"), (0.0, 1.0, "perfbench." + span)],
                        devices=(0,))
    assert read(metric, trace) == pytest.approx(30.0)


@pytest.mark.parametrize("metric,span", IDLE_READERS)
def test_idle_under_span_clipped_to_window(metric, span):
    """Spans reaching before 0 and past the window's end count only inside
    it: [-0.5, 0.2) and [0.9, 1.5) over an idle card read 30%."""
    trace = DeviceTrace(window_s=1.0, intervals={},
                        host=[(-0.5, 0.2, "rrt." + span), (0.9, 1.5, "rrt." + span)],
                        devices=(0,))
    assert read(metric, trace) == pytest.approx(30.0)


@pytest.mark.parametrize("metric,span", IDLE_READERS)
def test_idle_under_span_mean_over_cards(metric, span):
    """Two cards: under the span [0, 0.5) card 0 idles 0.5 s, card 1 (busy
    [0.1, 0.4)) 0.2 s: the mean, 35%.  The sum of the span readers stays
    under the idle share."""
    trace = DeviceTrace(window_s=1.0, intervals={1: [(0.1, 0.4, "k")]},
                        host=[(0.0, 0.5, "rrt." + span)], devices=(0, 1))
    assert read(metric, trace) == pytest.approx(35.0)
    assert read(metric, trace) <= read("device_idle_pct.render", trace)


@pytest.mark.parametrize("metric,span", IDLE_READERS)
def test_idle_under_span_none_where_absent(metric, span):
    """No trace, or no event of the span (other spans, the benchmark's own
    `perfbench.*` wrappers, a span wholly outside the window): None."""
    assert read(metric, None) is None
    trace = DeviceTrace(window_s=1.0, intervals={},
                        host=[(0.0, 1.0, "rrt.elsewhere"), (0.0, 1.0, "perfbench." + span),
                              (1.2, 1.5, "rrt." + span)],
                        devices=(0,))
    assert read(metric, trace) is None


@pytest.mark.parametrize("metric,name", [("capture_s", "graphs.capture"),
                                         ("scene_compile_s", "scene.compile")])
def test_total_readers(monkeypatch, metric, name):
    """capture_s and scene_compile_s read the seconds of totals(); None
    where the program has no such event or no totals (an older
    checkout)."""
    monkeypatch.setattr(tmetrics, "_totals", {name: [3, 1.25]})
    assert read(metric, None) == 1.25
    monkeypatch.setattr(tmetrics, "_totals", {})
    assert read(metric, None) is None
    monkeypatch.delattr(tmetrics, "totals")
    assert read(metric, None) is None
