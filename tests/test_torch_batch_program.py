"""The batch render's batch program (render/renderer.py:BatchProgram and
BatchRun, render/graphs.py:LoopGraph and PlainLoop, ops/loop_cond.py) on
the CPU.

On the card a batch of render(mode="batch") is one launch of a graph that
holds the lane ids, the camera rays, the bounce loop with its stop test
and the scatter back; here the same stages run through PlainLoop, the
loop's plain form, so these tests hold what decides whether the graph is
right:

- the lane ids made on the device from a 0-d start equal the numpy ids of
  the batch render (exactly);
- the program equals today's `trace_batch` on the same ids bit for bit,
  stops at the same bounce, and is within tests/test_torch_trace.py's
  bounds of the JAX package's batch function;
- its stages run no op that a CUDA graph capture refuses;
- the pipelined render (batch i summed while batch i + 1 runs) gives the
  unpipelined image bit for bit, with the same counts;
- scripts/mesh_batch_program.py's CPU rehearsal passes.
"""
import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytracer_tpu.render.renderer import Renderer as JRenderer
from rust_raytracer_tpu.utils import config as jcfg
from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.ops import bvh8 as tbvh8
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.ops import loop_cond as tloop
from rust_raytracer_torch.ops import threaded as tthr
from rust_raytracer_torch.ops import wavefront as twf
from rust_raytracer_torch.parallel import mesh as tmesh
from rust_raytracer_torch.render import camera as tcam
from rust_raytracer_torch.render import film as tfilm
from rust_raytracer_torch.render import graphs as tgraphs
from rust_raytracer_torch.render import integrator as tint
from rust_raytracer_torch.render import renderer as trend
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.utils import config as tcfg

from test_torch_graph import CaptureCheck, excluded
from test_torch_scene import jax_graph, mini_dragon_scene

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
SPP, DEPTH, BATCH = 2, 8, 100


def sky_scene(g):
    """A diffuse two-triangle card facing the camera under an open sky: a
    lane ends when it escapes, so every path ends by its second bounce (a
    flat card cannot see itself), long before max_depth."""
    corners = np.array([[-0.3, -0.3, 0.0], [0.3, -0.3, 0.0], [0.3, 0.3, 0.0], [-0.3, 0.3, 0.0]])
    tris = np.zeros((2, 3, 3), np.int32)
    tris[:, :, 0] = [[0, 1, 2], [0, 2, 3]]
    tris[:, :, 2] = -1
    card = g.Mesh(corners, np.array([[0.0, 0.0, 1.0]]), np.zeros((0, 2)), tris,
                  g.Lambertian(g.Constant((0.2, 0.7, 0.2))))
    sky = g.Sky(g.Constant((0.5, 0.7, 1.0)))
    return g.SceneDef(world=g.Group([card, sky]), lights=[sky], config={})


def mini_camera(depth=DEPTH, spp=SPP):
    sc = tcfg.merge_scene_config(mini_dragon_scene(tg).config, {"output_width": 16})
    return tcam.camera_from_config(sc, tcfg.RenderConfig(samples_per_pixel=spp,
                                                         max_depth=depth))


def sky_camera():
    return tcam.Camera(image_width=16, aspect_ratio=1.0, samples_per_pixel=SPP,
                       max_depth=DEPTH, position=(0.0, 0.0, 1.6), look_at=(0.0, 0.0, 0.0),
                       focal_length=35.0)


@pytest.fixture(scope="module")
def scenes():
    return {"mini_dragon": (mini_dragon_scene(tg), mini_camera()),
            "sky": (sky_scene(tg), sky_camera())}


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    """graphs.applies as on the card, so render_batched takes the batch
    program's path on the CPU (its loop a PlainLoop)."""
    monkeypatch.setattr(tgraphs, "applies",
                        lambda device, kernel, pack: tisect.resolve_kernel(kernel, pack) != "jnp")


def numpy_ids(start, n, total, spp, width):
    """The batch render's lane ids as it made them in numpy."""
    lane = start + np.arange(n)
    flat = lane % total
    pix = flat // spp
    return lane, pix % width, pix // width, flat % spp


def totals(cam):
    return cam.image_width * cam.image_height * cam.actual_spp


def trace_batch_ids(r, start, n):
    """(radiance with padded lanes zeroed, bounces) of the eager
    `trace_batch` on the numpy ids of the batch at `start`: the batch
    render's former path."""
    cam = r.camera
    lane, px, py, smp = numpy_ids(start, n, totals(cam), cam.actual_spp, cam.image_width)
    stats = {}
    rad = r.trace_batch(*(torch.from_numpy(a) for a in (px, py, smp)), stats).numpy()
    rad[lane >= totals(cam)] = 0.0
    return rad, stats["bounces"]


def run_program(prog, start, seed):
    prog.start.fill_(start)
    prog.seed.fill_(seed)
    prog.run()
    return prog.out.numpy().copy(), int(prog.bounces)


def program_of(r, n=BATCH, offset=0):
    cam = r.camera
    return trend.BatchProgram(r.pack, r.static, cam, n, offset, totals(cam), cam.actual_spp,
                              r.kernel)


@pytest.mark.parametrize("start,n,total,spp,width", [
    (0, 64, 512, 1, 16), (448, 128, 512, 2, 16), (300, 300, 640, 4, 20),
    (7, 33, 40, 3, 5), (0, 6, 5, 1, 5), (2 ** 33, 50, 2 ** 33 + 20, 2, 7)])
def test_lane_ids_match_numpy(start, n, total, spp, width):
    """integrator.batch_lanes from a 0-d start equals the numpy ids exactly,
    the wrapped tail, a batch longer than the grid and int64 starts
    included."""
    got = tint.batch_lanes(torch.tensor(start), n, total, spp, width)
    for g, w in zip(got, numpy_ids(start, n, total, spp, width)):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("scene,kernel", [("mini_dragon", "threaded"), ("mini_dragon", "bvh8"),
                                          ("mini_dragon", "wavefront"), ("sky", "threaded")])
def test_batch_program_equals_trace_batch(scenes, scene, kernel):
    """The program with its plain loop equals trace_batch on the numpy ids
    bit for bit, at the first batch and at the wrapped tail batch, at two
    seeds on one program, with the same bounces; each bounce calls the
    walk once and the stop test once."""
    sc, cam = scenes[scene]
    r = trend.Renderer(sc, cam, batch_size=BATCH, kernel=kernel, device="cpu", graph=False)
    prog = program_of(r)
    tail = (totals(cam) // BATCH) * BATCH
    for start, seed in ((0, 0), (tail, 5), (0, 5)):
        r.seed = seed
        want, want_b = trace_batch_ids(r, start, BATCH)
        walks, conds = tthr.plain_calls + tbvh8.plain_calls, tloop.plain_calls
        got, got_b = run_program(prog, start, seed)
        np.testing.assert_array_equal(got, want)
        assert got_b == want_b > 0
        assert tloop.plain_calls - conds == got_b
        if kernel != "wavefront":
            assert tthr.plain_calls + tbvh8.plain_calls - walks == got_b


def test_batch_program_matches_jax_batch_fn():
    """The program against the JAX package's batch function (its
    `_batch_fn`, kernel="jnp") on the same ids and seed, at
    tests/test_torch_trace.py::test_trace_matches_jax's bounds: >= 0.99 of
    the lanes within rtol 1e-4 / atol 1e-5 and mean |d| / mean <= 1e-3."""
    cam = mini_camera(depth=4, spp=1)
    n = totals(cam)
    r = trend.Renderer(mini_dragon_scene(tg), cam, batch_size=n, kernel="threaded", device="cpu")
    got, _ = run_program(program_of(r, n), 0, 3)
    jsc = jcfg.merge_scene_config(mini_dragon_scene(jax_graph()).config, {"output_width": 16})
    jr = JRenderer(mini_dragon_scene(jax_graph()),
                   jcfg.make_camera(jsc, jcfg.RenderConfig(samples_per_pixel=1, max_depth=4)),
                   batch_size=n, kernel="jnp")
    _, px, py, smp = numpy_ids(0, n, n, 1, cam.image_width)
    want = np.asarray(jr._batch_fn(jr.pack, *(jnp.asarray(a, jnp.uint32) for a in (px, py, smp)),
                                   jnp.uint32(3)))
    assert np.isfinite(got).all() and (got > 0).any()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1).mean()
    rel = np.abs(got - want).mean() / np.abs(want).mean()
    assert close >= 0.99, close
    assert rel <= 1e-3, rel


@pytest.mark.parametrize("kernel", ["threaded", "bvh8", "wavefront"])
def test_batch_program_stages_are_capture_safe(scenes, monkeypatch, kernel):
    """The ids and rays (prologue), the bounce with its any-alive flag
    (body) and the scatter back (epilogue) run no op that a CUDA graph
    capture refuses, outside the traversal kernels' wrappers, after the
    warm-up run that builds the camera's constants."""
    sc, cam = scenes["mini_dragon"]
    r = trend.Renderer(sc, cam, batch_size=BATCH, kernel=kernel, device="cpu")
    prog = program_of(r)
    run_program(prog, 0, 1)
    check = CaptureCheck()
    for module, name in ((tbvh8, "intersect_triangles_bvh8"),
                         (tthr, "intersect_triangles_threaded"),
                         (twf, "cull_compact"), (twf, "mt")):
        excluded(monkeypatch, check, module, name)
    prog.start.fill_(BATCH)
    refused = {}
    for stage in ("prologue", "body", "epilogue"):
        with check:
            getattr(prog, stage)()
        refused[stage], check.refused = check.refused, []
    assert refused == {"prologue": [], "body": [], "epilogue": []}, refused


@pytest.mark.parametrize("alive,depth,max_depth,flag", [
    ([True, False], 3, 8, 1), ([False, False], 3, 8, 0), ([True], 8, 8, 0), ([True], 0, 0, 0)])
def test_loop_cond_plain(alive, depth, max_depth, flag):
    """loop_cond's wrapper on CPU tensors writes any(alive) & (depth <
    max_depth) and adds one to the bounce counter; wrong dtypes raise."""
    any_alive = torch.tensor(alive).any()
    d = torch.tensor(depth)
    f = torch.full((), 7, dtype=torch.uint8)
    b = torch.tensor(4)
    calls = tloop.plain_calls
    tloop.loop_cond(any_alive, d, f, b, max_depth)
    assert int(f) == flag and int(b) == 5 and tloop.plain_calls == calls + 1
    assert bool(tloop.flag_plain(torch.tensor(alive), d, max_depth)) == bool(flag)
    with pytest.raises(TypeError):
        tloop.loop_cond(any_alive, d.to(torch.int32), f, b, max_depth)


def test_early_ending_scene_stops_at_the_same_bounce(scenes, monkeypatch):
    """On the sky scene every path ends before max_depth: the plain loop's
    stop test (loop_cond's plain version after each body) stops at the
    bounce where the host-read loop stops, and at each bounce its flag is
    the host's alive.any() & (depth < max_depth).  Bounces and radiance
    are equal."""
    sc, cam = scenes["sky"]
    r = trend.Renderer(sc, cam, batch_size=BATCH, kernel="threaded", device="cpu")
    prog = program_of(r)
    flags = []
    real = tloop.loop_cond

    def watched(any_alive, depth, flag, bounces, max_depth):
        real(any_alive, depth, flag, bounces, max_depth)
        flags.append((int(flag), bool(prog.state.alive.any()) and int(depth) < max_depth))

    monkeypatch.setattr(tloop, "loop_cond", watched)
    for start in (0, BATCH, 2 * BATCH):
        flags.clear()
        want, want_b = trace_batch_ids(r, start, BATCH)
        got, got_b = run_program(prog, start, 0)
        np.testing.assert_array_equal(got, want)
        assert 1 <= got_b == want_b < DEPTH
        assert len(flags) == got_b and [f for f, _ in flags] == [1] * (got_b - 1) + [0]
        assert all(f == host for f, host in flags)


def unpipelined(r):
    """render_batched as it stood: numpy ids uploaded, trace_batch, then
    each batch summed on the host before the next runs."""
    cam = r.camera
    w, h = cam.image_width, cam.image_height
    total, spp = totals(cam), cam.actual_spp
    batch = min(r.batch_size, total)
    if r.mesh is not None:
        batch = -(-batch // r.mesh.n_shards) * r.mesh.n_shards
    accum = np.zeros((w * h, 3), np.float64)
    batches = bounces = 0
    for start in range(0, total, batch):
        rad, b = trace_batch_ids(r, start, batch)
        pix = (start + np.arange(batch)) % total // spp
        for c in range(3):
            accum[:, c] += np.bincount(pix, weights=rad[:, c], minlength=w * h)
        batches, bounces = batches + 1, bounces + b
    film = tfilm.Film(w, h)
    film.add_samples(accum.reshape(h, w, 3), spp)
    return film.hdr(), batches, bounces


@pytest.mark.parametrize("batch,shards", [(1024, 0), (BATCH, 0), (BATCH, 2)])
def test_pipelined_render_equals_unpipelined(scenes, graphs_on_cpu, batch, shards):
    """render(mode="batch") through the batch programs, the host summing
    batch i after issuing batch i + 1, gives the unpipelined image bit for
    bit, at one batch (1024 lanes) and at four with a wrapped tail, and on
    make_mesh(2, device="cpu"); so does the eager render (graph=False).
    BatchMetrics counts the same batches and bounces each way."""
    sc, cam = scenes["mini_dragon"]
    mesh = tmesh.make_mesh(shards, device="cpu") if shards else None
    r = trend.Renderer(sc, cam, batch_size=batch, kernel="threaded", device="cpu", mesh=mesh)
    want, batches, bounces = unpipelined(r)
    for graph in (True, False):
        r.graph = graph
        m = trend.BatchMetrics()
        np.testing.assert_array_equal(r.render(mode="batch", metrics=m).hdr(), want)
        assert (m.batches, m.bounces) == (batches, bounces)
    assert batches == -(-totals(cam) // batch)


def test_batch_metrics_and_launch_counts(scenes, graphs_on_cpu):
    """On the early-ending scene the pipelined render counts the batches
    and the bounces the eager render counts, each bounce one walk and one
    stop test; the host split is recorded."""
    sc, cam = scenes["sky"]
    r = trend.Renderer(sc, cam, batch_size=BATCH, kernel="threaded", device="cpu")
    got = {}
    for graph in (True, False):
        r.graph = graph
        m = trend.BatchMetrics()
        walks, conds = tthr.plain_calls, tloop.plain_calls
        r.render(mode="batch", metrics=m)
        got[graph] = (m.batches, m.bounces, tthr.plain_calls - walks)
        assert m.launch_s > 0 and m.sum_s > 0 and m.wait_s >= 0
        assert tloop.plain_calls - conds == (m.bounces if graph else 0)
    assert got[True] == got[False]
    batches, bounces, walks = got[True]
    assert batches == -(-totals(cam) // BATCH) and walks == bounces < batches * DEPTH


def test_renderer_keeps_one_batch_program(scenes, graphs_on_cpu):
    """The Renderer builds its batch programs once and replays them at
    every seed (the seed is a 0-d tensor of the program); another batch
    layout replaces them.  Images equal the eager render's at each seed."""
    sc, cam = scenes["mini_dragon"]
    r = trend.Renderer(sc, cam, batch_size=BATCH, kernel="threaded", device="cpu")
    eager = trend.Renderer(sc, cam, batch_size=BATCH, kernel="threaded", device="cpu",
                           graph=False)
    runs = []
    for seed in (0, 4, 0):
        r.seed = eager.seed = seed
        np.testing.assert_array_equal(r.render(mode="batch").hdr(),
                                      eager.render(mode="batch").hdr())
        (entry,) = [v for k, v in r._graphs.items() if k[0] == "batch"]
        runs.append(entry[1])
    assert runs[0] is runs[1] is runs[2]
    r.batch_size = 2 * BATCH
    r.render(mode="batch")
    (entry,) = [v for k, v in r._graphs.items() if k[0] == "batch"]
    assert entry[1] is not runs[0]


def test_loop_graph_count_advances_counters():
    """LoopGraph.count adds a run's bodies times the body's launches, and
    one loop_cond launch a body, to the launch counters."""
    before = tgraphs.launch_counts()
    fake = types.SimpleNamespace(launched={"threaded_traverse": 1, "loop_cond": 1})
    tgraphs.LoopGraph.count(fake, 7)
    after = tgraphs.launch_counts()
    tgraphs._set_launches(before)
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "threaded_traverse": 7, "loop_cond": 7}


def test_wf_check_prints_overflow_and_turns_graphs_off(scenes, monkeypatch, capsys):
    """With RRT_WF_CHECK set, each wavefront call prints its overflowed
    packets to stderr in the reference's words, and graphs.applies is False
    (the print reads the device back)."""
    sc, cam = scenes["mini_dragon"]
    r = trend.Renderer(sc, cam, batch_size=BATCH, kernel="wavefront", device="cpu")
    assert tgraphs.applies("cuda", "wavefront", r.pack)
    lane = torch.arange(256)
    ctx = trng.Ctx(pixel=lane, sample=lane * 0, bounce=0, seed=0)
    org, dirn = cam.generate_rays(lane % 16, lane // 16 % 16, lane * 0, ctx)
    t_max = torch.full((256,), float("inf"))
    monkeypatch.setenv("RRT_WF_CHECK", "1")
    assert not tgraphs.applies("cuda", "wavefront", r.pack)
    assert not tgraphs.applies("cuda", "threaded", r.pack)
    _, _, ov = twf.intersect_triangles_wavefront(r.pack, org.contiguous(), dirn, 1e-3, t_max,
                                                 return_overflow=True, k1=1, kc=1)
    err = capsys.readouterr().err
    assert err == (f"wavefront: {int(ov)} packet(s) overflowed PAIRS_PER_PACKET_CAP "
                   "(farthest clusters dropped)\n")
    assert int(ov) > 0
    monkeypatch.delenv("RRT_WF_CHECK")
    twf.intersect_triangles_wavefront(r.pack, org.contiguous(), dirn, 1e-3, t_max)
    assert capsys.readouterr().err == ""


def test_mesh_batch_program_script_rehearsal():
    """scripts/mesh_batch_program.py's CPU rehearsal (two CPU shards, the
    graphed paths with their plain loops) passes its own checks: each
    sharded batch image equal to the unsharded one bit for bit, the pool's
    graphed image equal to its eager one within 1e-5."""
    script = os.path.join(os.path.dirname(HERE), "scripts", "mesh_batch_program.py")
    run = subprocess.run([sys.executable, script, "--device", "cpu", "--small"],
                         capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-2000:]
    (line,) = [x for x in run.stdout.splitlines() if x.startswith('{"mesh_batch_program"')]
    out = json.loads(line)["mesh_batch_program"]
    assert list(out["meshes"]) == ["2"] and out["bounces"] > 0
