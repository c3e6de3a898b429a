"""The graphed pool step (render/graphs.py) and the batch bounce on the CPU.

A CUDA graph cannot be captured here, so these tests hold what decides
whether the graph is right on the card:

- capture safety: a step issues no op that a capturing CUDA stream refuses
  (a read of the device back, or a tensor built from host memory), checked
  op by op under a TorchDispatchMode, with the traversal kernels' wrappers
  (a kernel launch on the card, a plain walk here) left out;
- the static-buffer bookkeeping: GraphedStep with the capture replaced by
  a direct call of the captured body equals the eager step bit for bit,
  returning its donated buffers, for one chain and for two chains stepped
  in turn through a step each, captures again when the pack, seed, spp or
  lane count changes, and advances the launch counters by what a replay
  launches;
- the graphed step's state against the JAX package's make_step after 12
  steps, at test_torch_render.py::test_pool_steps_match_jax's tolerance
  (rtol 1e-4, atol 2e-5 of a column's scale) on every lane but the few
  whose path flipped on a last-ulp difference.
"""
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rust_raytracer_tpu.render import pool as jpool
from rust_raytracer_tpu.render.renderer import Renderer as JRenderer
from rust_raytracer_tpu.utils import config as cfg
from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.ops import bvh8 as tbvh8
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.ops import threaded as tthreaded
from rust_raytracer_torch.ops import wavefront as twf
from rust_raytracer_torch.render import camera as tcam
from rust_raytracer_torch.render import graphs as tgraphs
from rust_raytracer_torch.render import integrator as tintegrator
from rust_raytracer_torch.render import pool as tpool
from rust_raytracer_torch.render import renderer as trend
from rust_raytracer_torch.render.renderer import Renderer as TRenderer
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.utils import metrics as tmetrics

from test_torch_render import _by_job
from test_torch_scene import jax_graph, mini_dragon_scene, port_pack_from_jax, port_static

torch.set_num_threads(2)

LANES, SPP, DEPTH = 256, 2, 8


def fog_scene(g):
    """The mini cornell_dragon with a fog sphere in the box (the smoke's fog
    render cut to size)."""
    scene = mini_dragon_scene(g)
    white = g.Lambertian(g.Constant((0.73, 0.73, 0.73)))
    fog = g.Volume(g.Sphere((200.0, 150.0, 250.0), 120.0, white),
                   g.Isotropic(g.Constant((1.0, 1.0, 1.0))), 0.01)
    return g.SceneDef(world=g.Group(list(scene.world.items) + [fog]), lights=scene.lights,
                      config=dict(scene.config))


def dark_scene(g):
    """The mini cornell_dragon without a light to sample (the light pick's
    empty branch)."""
    scene = mini_dragon_scene(g)
    return g.SceneDef(world=scene.world, lights=[], config=dict(scene.config))


SCENES = {"mini_dragon": mini_dragon_scene, "fog": fog_scene, "dark": dark_scene}


def camera_of(scene, width=16, spp=SPP, depth=DEPTH):
    sc = cfg.merge_scene_config(scene.config, {"output_width": width})
    return tcam.camera_from_config(sc, cfg.RenderConfig(samples_per_pixel=spp,
                                                        max_depth=depth))


@pytest.fixture(scope="module")
def built():
    """name -> (scene, pack, static, camera), compiled on the CPU once."""
    out = {}
    for name, make in SCENES.items():
        scene = make(tg)
        pack, static = tcompiler.compile_scene(scene, "cpu")
        out[name] = (scene, pack, static, camera_of(scene))
    return out


# ---------------------------------------------------------------- capture safety

# ops a capturing CUDA stream refuses: a read of the device back, or a
# tensor built from Python data (a pageable host-to-device copy on the card)
_REFUSED = {"_local_scalar_dense", "nonzero", "masked_select", "lift_fresh", "_unique",
            "_unique2", "unique_dim", "unique_consecutive", "unique_dim_consecutive"}
_INDEX = {"index", "index_put", "index_put_", "_index_put_impl_"}


class CaptureCheck(TorchDispatchMode):
    """Records each op that a CUDA graph capture would refuse: the names in
    _REFUSED, indexing with a bool mask (a nonzero on the card), and a copy
    from a CPU tensor into a tensor on another device.  Ops run while
    `paused` is positive (the traversal kernels' wrappers) are not
    checked."""

    def __init__(self):
        super().__init__()
        self.refused = []
        self.paused = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if not self.paused:
            bad = name in _REFUSED
            if name in _INDEX:
                bad = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                          for i in args[1] if i is not None)
            if name == "copy_":
                bad = args[1].device.type == "cpu" and args[0].device.type != "cpu"
            if bad:
                self.refused.append(str(func))
        return func(*args, **kwargs)


def excluded(monkeypatch, check, module, name):
    """Run module.name with the check paused."""
    real = getattr(module, name)

    def call(*a, **k):
        check.paused += 1
        try:
            return real(*a, **k)
        finally:
            check.paused -= 1

    monkeypatch.setattr(module, name, call)


@pytest.mark.parametrize("op", ["item", "bool", "nonzero", "mask", "tensor", "unique",
                                "masked_select"])
def test_capture_check_sees_refused_ops(op):
    """The checker flags each kind of op a capture refuses."""
    x = torch.arange(6.0)
    run = {"item": lambda: x.sum().item(), "bool": lambda: bool(x.any()),
           "nonzero": lambda: torch.nonzero(x), "mask": lambda: x[x > 2],
           "tensor": lambda: torch.tensor([0.0, 0.0, 1.0]),
           "unique": lambda: torch.unique(x), "masked_select": lambda: x.masked_select(x > 2)}
    with CaptureCheck() as check:
        run[op]()
    assert check.refused, op
    with CaptureCheck() as check:
        torch.where(x > 2, x, 0.0) * 2.0 + torch.full((3,), 1.0).sum()
    assert not check.refused


@pytest.mark.parametrize("scene,kernel,what", [
    ("mini_dragon", "bvh8", "pool"), ("mini_dragon", "wavefront", "pool"),
    ("fog", "bvh8", "pool"), ("dark", "bvh8", "pool"),
    ("mini_dragon", "threaded", "bounce"), ("fog", "wavefront", "bounce")])
def test_step_is_capture_safe(built, monkeypatch, scene, kernel, what):
    """One pool step (or one batch bounce) deep into a render issues no op
    that a CUDA graph capture refuses, outside the traversal kernels'
    wrappers.  The step before it, as GraphedStep's warm-up, fills the
    camera's lazily built constants."""
    _, pack, static, cam = built[scene]
    check = CaptureCheck()
    for module, name in ((tbvh8, "intersect_triangles_bvh8"),
                         (tthreaded, "intersect_triangles_threaded"),
                         (twf, "cull_compact"), (twf, "mt")):
        excluded(monkeypatch, check, module, name)
    n_pixels = cam.image_width * cam.image_height
    if what == "pool":
        step = tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, 0, kernel=kernel)
        state = tpool.init_state(LANES, n_pixels, "cpu")
    else:
        step = tintegrator.bounce_step(static, cam.light_bias, True, kernel)
        state = bounce_start(cam, LANES)
    for _ in range(3):
        state = step(pack, state)
    with check:
        state = step(pack, state)
    assert not check.refused, check.refused
    assert bool(state.active.any() if what == "pool" else state.alive.any())


# ---------------------------------------------------------------- static buffers

class DirectCapture:
    """Stands in for the CUDA capture: `replay` calls the captured body.
    Counts the captures (and, under graphs_on_cpu, in `loops` the batch
    programs' loops built)."""

    def __init__(self):
        self.count = 0
        self.loops = 0

    def __call__(self, body, device):
        self.count += 1
        return types.SimpleNamespace(replay=body)


def counted(monkeypatch, module, name):
    """module.name counting one launch a call in module.launches, as the
    kernel's wrapper does on the card."""
    real = getattr(module, name)

    def call(*a, **k):
        module.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(module, name, call)


def assert_states_equal(got, want, tag):
    for f, g, w in zip(type(want)._fields, got, want):
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w), f"{tag}: {f}"
        else:
            assert g == w, f"{tag}: {f}"


@pytest.mark.parametrize("kernel", ["bvh8", "wavefront"])
def test_graphed_pool_step_equals_eager(built, monkeypatch, kernel):
    """Over 12 steps the static-buffer step equals the eager step bit for
    bit, and returns its buffers (the same tensors every step: the state is
    donated).  A second chain, stepped in turn with the first, gets a step
    of its own and both equal the eager chains.  A state the step did not
    return is copied in; the one it returned, changed in place, is read
    as changed.  One capture a step for all of it, and the launch counter
    advances by one a replay (the warm-up and the capture add none)."""
    _, pack, static, cam = built["mini_dragon"]
    counted(monkeypatch, tbvh8, "intersect_triangles_bvh8")
    n_pixels = cam.image_width * cam.image_height
    total = n_pixels * SPP
    eager = tpool.make_step(pack, static, cam, total, SPP, 0, kernel=kernel, graph=False)
    captures = DirectCapture(), DirectCapture()
    graphed, graphed_b = (tgraphs.GraphedStep(eager, capture=c) for c in captures)
    start = tpool.init_state(LANES, n_pixels, "cpu")
    wants = [start]
    for _ in range(12):
        wants.append(eager(pack, wants[-1]))
    tbvh8.launches = 0
    a = start
    for k in range(12):
        a = graphed(pack, a)
        assert_states_equal(a, wants[k + 1], f"step {k}")
        assert all(x is y for x, y in zip(a, graphed.captures[torch.device("cpu")].inputs))
    assert tbvh8.launches == (12 if kernel == "bvh8" else 0)

    # two chains in turn, one step each: b from where a stopped, a anew
    # from the start (a state the step did not return, copied in)
    b, wb = graphed_b(pack, a), eager(pack, wants[-1])
    a, wa = start, start
    for k in range(12):
        a, b = graphed(pack, a), graphed_b(pack, b)
        wa, wb = eager(pack, wa), eager(pack, wb)
        assert_states_equal(a, wa, f"chain a, step {k}")
        assert_states_equal(b, wb, f"chain b, step {k}")
    # the last state returned, changed in place, is read as changed
    b.throughput.mul_(0.5)
    wb = wb._replace(throughput=wb.throughput * 0.5)
    assert_states_equal(graphed_b(pack, b), eager(pack, wb), "changed in place")
    assert [c.count for c in captures] == [1, 1]


def test_graph_follows_pack_and_lanes(built):
    """A new capture for another pack (new tensors) or lane count; none for
    the same pack rebuilt around the same tensors."""
    _, pack, static, cam = built["mini_dragon"]
    n_pixels = cam.image_width * cam.image_height
    eager = tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, 0, graph=False)
    capture = DirectCapture()
    graphed = tgraphs.GraphedStep(eager, capture=capture)
    s = tpool.init_state(LANES, n_pixels, "cpu")
    s = graphed(pack, graphed(pack, s))
    assert capture.count == 1
    graphed(pack.to("cpu"), s)
    assert capture.count == 1
    other = pack._replace(tri_rows=pack.tri_rows.clone())
    assert_states_equal(graphed(other, s), eager(other, s), "other pack")
    assert capture.count == 2
    half = tpool.init_state(LANES // 2, n_pixels, "cpu")
    assert_states_equal(graphed(other, half), eager(other, half), "half the lanes")
    assert capture.count == 3
    assert graphed.captures[torch.device("cpu")].key[0][0] == (LANES // 2, 3)


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    """render/graphs.py as on the card, with DirectCapture for the capture:
    the pool step goes through GraphedStep on the CPU, and the batch
    render through its batch programs, whose loops (the
    graph's plain form here, graphs.PlainLoop) are counted in
    `capture.loops`."""
    capture = DirectCapture()
    monkeypatch.setattr(tgraphs, "applies",
                        lambda device, kernel, pack: tisect.resolve_kernel(kernel, pack) != "jnp")
    monkeypatch.setattr(tgraphs, "cuda_capture", capture)

    class CountedLoop(tgraphs.PlainLoop):
        def __init__(self, *args, **kwargs):
            capture.loops += 1
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(tgraphs, "PlainLoop", CountedLoop)
    return capture


def test_renderer_keeps_its_graphs(built, graphs_on_cpu, monkeypatch):
    """A Renderer captures its pool step once and replays it in a later
    render; another spp or seed gets its own graph.  The images equal the
    eager renders bit for bit, and the launch counter equals the steps."""
    scene, _, _, cam = built["mini_dragon"]
    counted(monkeypatch, tbvh8, "intersect_triangles_bvh8")
    r = TRenderer(scene, cam, batch_size=LANES, kernel="bvh8", device="cpu")
    eager = TRenderer(scene, cam, batch_size=LANES, kernel="bvh8", device="cpu", graph=False)
    cases = [(None, 0), (None, 0), (4, 0), (None, 5)]
    counts = []
    for spp, seed in cases:
        r.seed = seed
        tbvh8.launches = 0
        m = tmetrics.RenderMetrics()
        got = r.render(spp=spp, metrics=m).hdr()
        assert tbvh8.launches == m.steps > 0
        counts.append(graphs_on_cpu.count)
        eager.seed = seed
        np.testing.assert_array_equal(got, eager.render(spp=spp).hdr())
    assert counts == [1, 1, 2, 3]


def bounce_start(cam, n, seed=0):
    """A BounceState of `n` camera rays over the image (as trace starts)."""
    w, h = cam.image_width, cam.image_height
    lane = torch.arange(n)
    px, py, smp = lane % w, (lane // w) % h, lane // (w * h)
    ctx = trng.Ctx(pixel=py * w + px, sample=smp, bounce=0, seed=seed)
    org, dirn = cam.generate_rays(px, py, smp, ctx)
    return tintegrator.BounceState(
        org=org, dirn=dirn, throughput=torch.ones((n, 3)), radiance=torch.zeros((n, 3)),
        alive=torch.ones((n,), dtype=torch.bool), src=torch.arange(n),
        pixel=trng.as_u32(ctx.pixel), sample=trng.as_u32(ctx.sample), depth=0, seed=seed)


@pytest.mark.parametrize("kernel", ["threaded", "wavefront"])
def test_graphed_bounce_equals_trace(built, graphs_on_cpu, monkeypatch, kernel):
    """The bounce as the batch program runs it (render/renderer.py:
    BatchProgram, the body of its loop; the loop a PlainLoop here) equals
    the eager trace bit for bit, for two batches of one program, with K3
    launches equal to the bounces; the bounce index lives in a 0-d tensor
    that the body advances.  trace() itself captures nothing: it is the
    program's plain version."""
    _, pack, static, cam = built["fog"]
    counted(monkeypatch, tthreaded, "intersect_triangles_threaded")
    w = cam.image_width
    total = w * cam.image_height * SPP
    prog = trend.BatchProgram(pack, static, cam, LANES, 0, total, SPP, kernel)
    for start, seed in ((0, 3), (LANES, 4)):
        tthreaded.launches = 0
        prog.start.fill_(start)
        prog.seed.fill_(seed)
        prog.run()
        bounces = int(prog.bounces)
        assert tthreaded.launches == (bounces if kernel == "threaded" else 0)
        assert int(prog.state.depth) == bounces > 1
        _, px, py, smp = tintegrator.batch_lanes(torch.tensor(start), LANES, total, SPP, w)
        ctx = trng.Ctx(pixel=py * w + px, sample=smp, bounce=0, seed=seed)
        org, dirn = cam.generate_rays(px, py, smp, ctx)
        stats = {}
        want = tintegrator.trace(pack, static, org, dirn, ctx, cam.max_depth, cam.light_bias,
                                 kernel=kernel, stats=stats)
        assert stats["bounces"] == bounces
        assert torch.equal(prog.out, want)
    assert (graphs_on_cpu.loops, graphs_on_cpu.count) == (1, 0)


def test_batch_render_through_graphed_bounce(built, graphs_on_cpu):
    """render(mode="batch") runs its batch program (render/renderer.py:
    BatchProgram: the whole batch, its bounce loop included, one graph
    launch on the card), built once and kept for the second render, and
    gives the eager render's image bit for bit; neither captures the
    per-bounce step."""
    scene, _, _, cam = built["mini_dragon"]
    r = TRenderer(scene, cam, batch_size=LANES, kernel="threaded", device="cpu")
    imgs = [r.render(mode="batch").hdr() for _ in range(2)]
    assert (graphs_on_cpu.loops, graphs_on_cpu.count) == (1, 0)
    r.graph = False
    want = r.render(mode="batch").hdr()
    assert (graphs_on_cpu.loops, graphs_on_cpu.count) == (1, 0)
    for img in imgs:
        np.testing.assert_array_equal(img, want)


def test_debug_nans_runs_eagerly(built):
    """Under debug_nans the graphed step calls its body eagerly (no
    capture), and the body's NaN check raises at the step."""
    _, pack, static, cam = built["mini_dragon"]
    n_pixels = cam.image_width * cam.image_height
    capture = DirectCapture()
    graphed = tgraphs.GraphedStep(
        tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, 0, graph=False),
        capture=capture)
    s = graphed(pack, tpool.init_state(LANES, n_pixels, "cpu"))
    bad = s._replace(throughput=s.throughput.clone())
    bad.throughput[0] = float("nan")
    bad = bad._replace(active=torch.ones_like(bad.active))
    with tmetrics.debug_nans(), pytest.raises(FloatingPointError, match="pool step"):
        graphed(pack, bad)
    assert capture.count == 1


# ---------------------------------------------------------------- against JAX

def test_graphed_pool_steps_match_jax():
    """12 steps of the static-buffer step (the capture a direct call) against
    12 of the JAX package's make_step (kernel="jnp") from the same start on
    the mini cornell_dragon at 32x32, 4 spp, depth 8, 1024 lanes: the same
    jobs in flight at the same bounce, the same jobs issued, the image
    accumulator within test_pool_steps_match_jax's rtol 1e-4 / atol 2e-5
    of its scale, and each lane's state columns within the same tolerance,
    but for the lanes whose path flipped on a last-ulp difference (ROADMAP
    Queue 3): from step 7 on, 1-3 of the 1024 lanes a step carry a path
    that left the reference's at an edge hit (measured, steps 7-20; 2 at
    step 12).  At most 0.5% of the live lanes may do so, the share of
    pixels test_pool_render_matches_jax allows outside its tolerance.  The
    graphed state equals the eager step's bit for bit, so the flips are the
    eager port's."""
    lanes = 1024
    sc = cfg.merge_scene_config(mini_dragon_scene(tg).config, {"output_width": 32})
    rc = cfg.RenderConfig(samples_per_pixel=4, max_depth=8)
    jr = JRenderer(mini_dragon_scene(jax_graph()), cfg.make_camera(sc, rc),
                   batch_size=lanes, kernel="jnp")
    cam = tcam.camera_from_config(sc, rc)
    n_pixels = cam.image_width * cam.image_height
    spp = cam.actual_spp
    total = n_pixels * spp
    jstep = jpool.make_step(jr.pack, jr.static, jr.camera, total, spp, 0, kernel="jnp")
    tpack = port_pack_from_jax(jr.pack)
    eager = tpool.make_step(tpack, port_static(jr.static), cam, total, spp, 0, graph=False)
    tstep = tgraphs.GraphedStep(eager, capture=DirectCapture())
    js = jpool.init_state(lanes, n_pixels)
    ts = es = tpool.init_state(lanes, n_pixels, "cpu")
    for _ in range(12):
        js, ts, es = jstep(jr.pack, js), tstep(tpack, ts), eager(tpack, es)
    assert_states_equal(ts, es, "graphed vs eager")
    cols = ("org", "dirn", "throughput", "radiance", "bounce")
    assert int(ts.next_flat) == int(js.next_flat[0])
    got = _by_job(ts.pixel, ts.sample, ts.active, *(getattr(ts, c) for c in cols))
    want = _by_job(js.pixel, js.sample, js.active, *(getattr(js, c) for c in cols))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[-1], want[-1])
    off = np.zeros(len(got[0]), bool)
    for g, w in zip(got[2:-1], want[2:-1]):
        scale = max(float(np.abs(w).max()), 1.0)
        off |= ~np.isclose(g, w, rtol=1e-4, atol=2e-5 * scale).all(axis=1)
    assert off.sum() <= 0.005 * len(off), f"{off.sum()} of {len(off)} lanes off"
    for name, g, w in zip(cols[:-1], got[2:-1], want[2:-1]):
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g[~off], w[~off], rtol=1e-4, atol=2e-5 * scale,
                                   err_msg=name)
    want = np.asarray(js.accum[0])
    np.testing.assert_allclose(ts.accum.numpy(), want, rtol=1e-4,
                               atol=2e-5 * max(float(np.abs(want).max()), 1.0))
