"""The `smoke_render` cell on the CPU at a tiny size: the benchmark's plain
reference with volumes (perfbench/reference/volumes.py) against the port,
the planted faults the cell's comparison has to catch, the port's counter
of free-flight scattering events (the pool step's `volume_hits`,
RenderMetrics.volume_hits) and the cell's three readers
(perfbench/metrics/volume_scatter_pct.render.py, free_flight_ms.render.py,
free_flight_roofline_pct.render.py).

Sizes are perfbench/tests/small.py's cut: 16 pixels wide, 4 samples a
pixel, 2048 lanes.  A render agrees with the reference within the cell's
own limit (perfbench/limits/smoke_render.json): the port's slab test takes
a matrix product where the reference sums component by component, so a
path may flip on an ulp."""
import ast
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import perfbench.run as run
from perfbench.core import check, spec
from perfbench.core.devtrace import DeviceTrace
from perfbench.core.workload import Unit
from perfbench.reference import graph as rg
from perfbench.reference import hits as rhits
from perfbench.reference import tables as rtables
from perfbench.reference import volumes as rvol
from perfbench.tests.small import small_cell
from rust_raytracer_torch import models as tmodels
from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.ops import vertex as tvertex
from rust_raytracer_torch.parallel import mesh as tmesh
from rust_raytracer_torch.render import graphs as tgraphs
from rust_raytracer_torch.render import pool as tpool
from rust_raytracer_torch.render.camera import Camera
from rust_raytracer_torch.render.renderer import Renderer
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.scene import pack as tpack
from rust_raytracer_torch.utils.metrics import RenderMetrics

torch.set_num_threads(2)

WIDTH, SPP, LANES, SEED = 16, 4, 2048, 2 ** 31 + 17
ROOT = Path(spec.ROOT)


@pytest.fixture(autouse=True)
def _volume_support(monkeypatch):
    """The reference's volume support (volumes.install) for each test here,
    and the frozen functions it replaces put back after it."""
    for mod, name in ((rtables, "build"), (rhits, "merge_volumes"),
                      (rhits, "hit_attributes")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    rvol.install()


def _limit():
    return spec.load_cell("smoke_render").limits["pixel_mismatch_share"]


def _camera(width=WIDTH, spp=SPP):
    cfg = spec.load_cell("smoke_render").config
    return Camera(**{**cfg["camera"], "image_width": width}, samples_per_pixel=spp,
                  max_depth=cfg["max_depth"], light_bias=cfg["light_bias"])


def _reference_sums(monkeypatch, ref_scene, seed, spp=SPP, width=WIDTH):
    """The reference's radiance sums of every pixel of `ref_scene` under the
    cell's camera at `width`."""
    cell = spec.load_cell("smoke_render")
    cell.config["camera"]["image_width"] = width
    monkeypatch.setattr(spec, "scene_module",
                        lambda name: types.SimpleNamespace(build=lambda cfg: ref_scene))
    n = width * width
    return check.Reference(cell, "cpu", spp).pixel_sums(np.arange(n), [seed], spp)[0]


def _program_image(scene, seed, spp=SPP, width=WIDTH, metrics=None):
    film = Renderer(scene, _camera(width, spp), seed=seed, batch_size=LANES,
                    device="cpu").render(mode="pool", metrics=metrics)
    return film.accum.reshape(width * width, 3)


# ---------------------------------------------------------------- the reference


def test_reference_volume_modules_import_neither_program_nor_jax():
    banned = {"rust_raytracer_torch", "rust_raytracer_tpu", "jax", "jaxlib", "flax"}
    files = [ROOT / "perfbench" / "reference" / "volumes.py",
             ROOT / "perfbench" / "scenes" / "cornell_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {n.split(".")[0] for n in names} & banned, (f, names)


def test_tables_and_search_of_a_scene_without_triangles():
    """cornell_smoke has no triangle: its tables hold none, the search finds
    none, and the two volumes' boxes are worked out from the description
    (centres, half-sizes, rotations about y, -1/density, isotropic rows)."""
    scene = rtables.build(spec.scene_module("cornell_smoke").build({}), "cpu")
    assert scene.tri_attr.shape == (0, 32) and scene.tri_rows.shape == (0, 10)
    search = rhits.TriangleSearch(scene.tri_rows)
    t_max = torch.full((5,), 7.0)
    t, i = search.closest(torch.zeros(5, 3), torch.ones(5, 3), t_max)
    assert torch.equal(t, t_max) and bool((i == -1).all())
    np.testing.assert_allclose(scene.vol_center.numpy(),
                               [[6.25, -19.25, 12.75], [-7.25, -11.0, -10.25]], atol=1e-5)
    np.testing.assert_allclose(scene.vol_halfsize.numpy(),
                               [[8.25, 8.25, 8.25], [8.25, 16.5, 8.25]], atol=1e-5)
    np.testing.assert_allclose(scene.vol_neg_inv_density.numpy(), [-1 / 0.15] * 2, rtol=1e-6)
    a = np.deg2rad(-15.0)
    np.testing.assert_allclose(scene.vol_axes[0].numpy(),
                               [[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]],
                               atol=1e-6)
    assert scene.mat_type[scene.vol_mat.long()].tolist() == [rtables.MAT_ISOTROPIC] * 2


def test_volume_support_leaves_a_scene_without_volumes_as_it_was(monkeypatch):
    """Importing volumes.py replaces nothing, and in a scene without volumes
    the installed functions give the frozen ones' tables and sums, bit for
    bit: a volume-free cell's comparison does not depend on a volume scene
    built before it in the process."""
    installed = (rtables.build, rhits.merge_volumes, rhits.hit_attributes)
    frozen = (rvol._BUILD, rvol._MERGE, rvol._ATTRIBUTES)
    assert [f.__module__ for f in frozen] == [rtables.__name__, rhits.__name__, rhits.__name__]
    sums = []
    for fns in (installed, frozen):
        monkeypatch.setattr(rtables, "build", fns[0])
        monkeypatch.setattr(rhits, "merge_volumes", fns[1])
        monkeypatch.setattr(rhits, "hit_attributes", fns[2])
        scene = spec.scene_module("cornell").build({})
        tabs = rtables.build(scene, "cpu").tensors
        sums.append((tabs, _reference_sums(monkeypatch, scene, 11, spp=2, width=8)))
    (ta, a), (tb, b) = sums
    assert ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k]) for k in ta)
    assert np.array_equal(a, b)


def test_reference_refuses_other_boundaries():
    white = rg.Lambertian(rg.Constant(0.5))
    for boundary in (rg.Sphere((0, 0, 0), 1.0, white),
                     rg.Transform(rg.Box((0, 0, 0), (1, 1, 1), white)).rotate_z(30).scale(2, 1, 1)):
        scene = rg.SceneDef(world=rg.Group([rvol.Volume(boundary, rvol.Isotropic(
            rg.Constant(0.5)), 0.3)]), lights=[])
        with pytest.raises(NotImplementedError):
            rtables.build(scene, "cpu")


def test_reference_render_equals_program_on_smoke(monkeypatch):
    """Every pixel of a 16x16, 4-spp pool render of cornell_smoke against
    the reference's sums of the same samples, under the cell's camera."""
    ref = _reference_sums(monkeypatch, spec.scene_module("cornell_smoke").build({}), 7)
    got = _program_image(tmodels.build("cornell_smoke"), 7)
    gaps = check.pixel_mismatch(got[None], ref[None])
    assert gaps["pixel_mismatch_share"] <= _limit(), gaps
    assert float(np.abs(got - ref).mean()) <= 1e-4 * float(np.abs(ref).mean())


def random_volume_scene(g, volume, isotropic, seed: int):
    """cornell_smoke's room and light with two boxes of medium whose sizes,
    poses (about every axis), densities (0.02-0.5) and albedos are drawn
    from `seed`, in the scene description of `g` (`volume` and
    `isotropic` its Volume and Isotropic)."""
    rng = np.random.default_rng(seed)
    draws = [dict(size=rng.uniform(5.0, 20.0, 3), rot=rng.uniform(-60.0, 60.0, 3),
                  at=rng.uniform(-12.0, 12.0, 3), albedo=rng.uniform(0.0, 1.0, 3),
                  density=rng.uniform(0.02, 0.5)) for _ in range(2)]
    white = g.Lambertian(g.Constant((0.73, 0.73, 0.73)))
    walls = [g.Plane((0, -27.5, 0), (-27.5, 0, 0), (0, 0, 27.5), white),
             g.Plane((0, 27.5, 0), (27.5, 0, 0), (0, 0, -27.5), white),
             g.Plane((0, 0, -27.5), (0, 27.5, 0), (-27.5, 0, 0), white),
             g.Plane((-27.5, 0, 0), (0, 27.5, 0), (0, 0, -27.5),
                     g.Lambertian(g.Constant((0.12, 0.45, 0.15)))),
             g.Plane((27.5, 0, 0), (0, 27.5, 0), (0, 0, 27.5),
                     g.Lambertian(g.Constant((0.65, 0.05, 0.05))))]
    light = g.Plane((0, 27.49, 0), (13, 0, 0), (0, 0, 10.5),
                    g.Emissive(g.Constant((15.0, 15.0, 15.0))))
    vols = []
    for d in draws:
        box = g.Transform(g.Box((0, 0, 0), tuple(d["size"]), white))
        box.rotate_x(d["rot"][0]).rotate_y(d["rot"][1]).rotate_z(d["rot"][2])
        box.translate(*d["at"])
        vols.append(volume(box, isotropic(g.Constant(tuple(d["albedo"]))), float(d["density"])))
    return g.SceneDef(world=g.Group(walls + [light] + vols), lights=[light])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_render_equals_program_on_random_volumes(monkeypatch, seed):
    """The same comparison on three seeded scenes of two random boxes of
    medium, each built in both scene descriptions."""
    ref_scene = random_volume_scene(rg, rvol.Volume, rvol.Isotropic, seed)
    prog_scene = random_volume_scene(tg, tg.Volume, tg.Isotropic, seed)
    pack, _ = tcompiler.compile_scene(prog_scene, "cpu")
    assert pack.vol_kinds == (tpack.VOL_BOX,) * 2
    ref = _reference_sums(monkeypatch, ref_scene, 100 + seed)
    got = _program_image(prog_scene, 100 + seed)
    gaps = check.pixel_mismatch(got[None], ref[None])
    assert gaps["pixel_mismatch_share"] <= _limit(), gaps


# ---------------------------------------------------------------- faults


def _edit_scene(monkeypatch, edit):
    """models.build returning cornell_smoke with `edit(world items)` applied."""
    orig = tmodels.build

    def build(name):
        scene = orig(name)
        edit(scene.world.items)
        return scene

    monkeypatch.setattr(tmodels, "build", build)


def _density_off(monkeypatch):
    """Each volume's density 1% high."""
    def edit(items):
        for v in items:
            if isinstance(v, tg.Volume):
                v.density *= 1.01
    _edit_scene(monkeypatch, edit)


def _one_stream(monkeypatch):
    """Both volumes draw their free flight from stream VOLUME."""
    orig = trng.Ctx.uniform

    def uniform(self, stream):
        return orig(self, trng.Streams.VOLUME if stream == trng.Streams.VOLUME + 16 else stream)

    monkeypatch.setattr(trng.Ctx, "uniform", uniform)


def _second_volume_dropped(monkeypatch):
    def edit(items):
        assert isinstance(items[-1], tg.Volume)
        del items[-1]
    _edit_scene(monkeypatch, edit)


def _cosine_scattering(monkeypatch):
    """Isotropic scattering replaced by cosine scattering about the stored
    normal (the volumes' material a Lambertian of the same albedo)."""
    def edit(items):
        for v in items:
            if isinstance(v, tg.Volume):
                v.material = tg.Lambertian(v.material.albedo)
    _edit_scene(monkeypatch, edit)


FAULTS = [_density_off, _one_stream, _second_volume_dropped, _cosine_scattering]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_planted_volume_fault_is_not_correct(fault, monkeypatch):
    cell = small_cell("smoke_render", monkeypatch)
    fault(monkeypatch)
    res = run.run_cell(cell, SEED, 0.05, False, device="cpu")
    assert res["correct"] is False, res["checks"]


def test_sound_smoke_run_is_correct(monkeypatch):
    cell = small_cell("smoke_render", monkeypatch)
    res = run.run_cell(cell, SEED, 0.05, False, device="cpu")
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["render_pixel_samples_per_s"]["value"] > 0


# ---------------------------------------------------------------- the counter


def test_volume_hits_counts_the_plain_paths_scattering_events(monkeypatch):
    """RenderMetrics.volume_hits of a pool render equals the PRIM_VOLUME
    hits of live lanes that the plain vertex's `intersect` returned; a
    second render of the same Renderer counts the same (the step's counter
    is zeroed at each render's start)."""
    seen = []
    orig = tisect.intersect

    def intersect(pack, org, dirn, t_min, ctx, alive=None, **k):
        out = orig(pack, org, dirn, t_min, ctx, alive=alive, **k)
        hit = out[0] if isinstance(out, tuple) else out
        seen.append(int(((hit.kind == tpack.PRIM_VOLUME) & alive).sum()))
        return out

    monkeypatch.setattr(tisect, "intersect", intersect)
    r = Renderer(tmodels.build("cornell_smoke"), _camera(), seed=5, batch_size=LANES,
                 device="cpu")
    counts = []
    for _ in range(2):
        metrics = RenderMetrics(n_pixels=WIDTH * WIDTH, spp=SPP, max_depth=20)
        r.render(mode="pool", metrics=metrics)
        counts.append(metrics.volume_hits)
        assert metrics.summary()["volume_hits"] == metrics.volume_hits
    assert counts[0] == counts[1] == sum(seen) // 2 > 0


def test_volume_hits_is_the_same_over_lane_counts_and_shards():
    """A sample's path depends on its ids, not on its lane: the count is the
    same at another pool size and over a mesh of two shards."""
    scene = tmodels.build("cornell_smoke")
    pack, static = tcompiler.compile_scene(scene, "cpu")
    cam = _camera()
    n_pixels = WIDTH * WIDTH
    counts = []
    for lanes, mesh in ((LANES, None), (LANES // 2, None),
                        (LANES, tmesh.make_mesh(2, device="cpu"))):
        metrics = RenderMetrics(n_pixels=n_pixels, spp=SPP, max_depth=20)
        tpool.run_pool(pack, static, cam, n_pixels, SPP, lanes, "cpu", seed=5,
                       metrics=metrics, mesh=mesh)
        counts.append(metrics.volume_hits)
    assert counts[0] == counts[1] == counts[2] > 0


def test_scene_without_volumes_leaves_the_counter_out():
    """In a scene without volumes a step adds nothing to its counters' volume
    row, the pool state has its fields of before, and a render records no
    volume_hits."""
    cam = _camera()
    pack, static = tcompiler.compile_scene(tmodels.build("cornell"), "cpu")
    assert not pack.vol_kinds
    n_pixels = WIDTH * WIDTH
    step = tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, 0)
    (counters,) = step.counters
    state = tpool.init_state(LANES, n_pixels, "cpu")
    assert tpool.PoolState._fields[8:] == ("accum", "next_flat", "overflow")
    metrics = RenderMetrics(n_pixels=n_pixels, spp=SPP, max_depth=20)
    counters[tvertex.ROW_VOLUME] = 7
    for _ in range(3):
        state = step(pack, state)
    assert counters[tvertex.ROW_VOLUME].tolist() == [7] * tvertex.VOLUME_SLOTS
    tpool.run_pool(pack, static, cam, n_pixels, SPP, LANES, "cpu", metrics=metrics, step=step)
    assert int(counters[tvertex.ROW_VOLUME].sum()) == 0
    assert metrics.volume_hits == 0 and "volume_hits" not in metrics.summary()


def test_volume_hits_graphed_equals_eager():
    """The counter through a (stand-in) graphed step whose capture's warm-up
    runs the step once more: equal to the eager step's, step for step."""
    cam = _camera()
    pack, static = tcompiler.compile_scene(tmodels.build("cornell_smoke"), "cpu")
    n_pixels = WIDTH * WIDTH
    eager = tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, 3)
    inner = tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, 3)
    capture = lambda body, device: types.SimpleNamespace(replay=body)  # noqa: E731
    graphed = tgraphs.GraphedStep(inner, capture=capture, counters=inner.counters)
    a = b = tpool.init_state(LANES, n_pixels, "cpu")
    row = lambda step: int(step.counters[0][tvertex.ROW_VOLUME].sum())  # noqa: E731
    for _ in range(6):
        a, b = eager(pack, a), graphed(pack, b)
        assert row(eager) == row(inner)
    assert row(eager) > 0


# ---------------------------------------------------------------- readers


def _reader(name):
    return spec.metric_reader(name)


def _ctx(trace, counters, lanes=1024):
    units = [Unit(0.0, 1.0, 100, True, c) for c in counters]
    return types.SimpleNamespace(trace=trace, traced_units=units, units=units,
                                 sizes={"lanes": lanes, "triangles": 0})


def _trace(ivs, window=1.0):
    return DeviceTrace(window_s=window, intervals={0: ivs}, host=[], devices=(0,))


STEP = [(0.00, 0.01, "vertex_hit_kernel(float const*)"),
        (0.02, 0.03, "void at::native::elementwise_kernel<128, 2>(int)"),
        (0.025, 0.04, "void at::native::vectorized_elementwise_kernel<4>(int)"),
        (0.05, 0.06, "Memcpy DtoD (Device -> Device)"),
        (0.07, 0.08, "vertex_shade_kernel(float const*)"),
        (0.09, 0.10, "lane_update_kernel(float const*)")]


def test_free_flight_ms_reads_the_stretch_before_shading():
    """Per traced render, the union of what ran between the last hit or
    walk kernel and the next shading kernel: (0.02-0.04) + (0.05-0.06)
    a step, two steps, two renders."""
    later = [(a + 0.1, b + 0.1, n) for a, b, n in STEP]
    walk = [(0.105, 0.11, "bvh8_traverse_kernel(float const*)")]
    ivs = sorted(STEP + later + walk)
    ctx = _ctx(_trace(ivs), [RenderMetrics(), RenderMetrics()])
    got = _reader("free_flight_ms.render")(ctx)
    assert got == pytest.approx(1e3 * (0.03 + 0.03) / 2)


def test_free_flight_readers_none_where_absent():
    counters = [RenderMetrics(lane_bounces=1000)]
    for name in ("free_flight_ms.render", "free_flight_roofline_pct.render"):
        assert _reader(name)(_ctx(None, counters)) is None
        assert _reader(name)(_ctx(_trace(STEP[3:]), counters)) is None
    old = types.SimpleNamespace(lane_bounces=1000)   # a program without the counter
    assert _reader("volume_scatter_pct.render")(_ctx(None, [old])) is None


def test_volume_scatter_pct_and_roofline():
    counters = [RenderMetrics(lane_bounces=4000, volume_hits=300),
                RenderMetrics(lane_bounces=6000, volume_hits=200)]
    ctx = _ctx(_trace(STEP), counters)
    assert _reader("volume_scatter_pct.render")(ctx) == pytest.approx(5.0)
    want = 100.0 * (10000 * 60 / 3.35e12) / 0.03
    assert _reader("free_flight_roofline_pct.render")(ctx) == pytest.approx(want)
