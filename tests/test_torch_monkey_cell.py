"""The `monkey_render` cell and the texture closures on the CPU at a tiny
size: the port's `golden_monkey` (its stand-in Suzanne without
resource/monkey.obj, the JAX package's scene with a stub OBJ), the
shading kernel's closure table (ops/vertex.py:texture_closures) read as
the kernel reads it against ops/texture.py:eval_program, the benchmark's
plain reference of the scene (perfbench/scenes/golden_monkey.py) against
the port, the planted faults the cell's comparison has to catch, the
port's counter of sphere hits (the pool step's `sphere_hits`,
RenderMetrics.sphere_hits) and the cell's four new readers.

Renders use perfbench/tests/small.py's cut (16 pixels wide, 4 samples a
pixel, 2048 lanes) with the torus knot cut to 40 x 16 in the port and in
the reference; the sphere field stays whole (461 spheres, 418
materials)."""
import ast
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import perfbench.run as run
from perfbench.core import check, spec
from perfbench.core.devtrace import DeviceTrace
from perfbench.core.peaks import HBM_BYTES_PER_S
from perfbench.core.workload import Unit
from perfbench.tests.small import KNOT, small_cell
from rust_raytracer_torch import models as tmodels
from rust_raytracer_torch.models import builtin as tbuiltin
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.ops import texture as ttex
from rust_raytracer_torch.ops import vertex
from rust_raytracer_torch.parallel import mesh as tmesh
from rust_raytracer_torch.render import camera as tcamera
from rust_raytracer_torch.render import graphs as tgraphs
from rust_raytracer_torch.render import pool as tpool
from rust_raytracer_torch.render.renderer import Renderer
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.scene import pack as tpack
from rust_raytracer_torch.utils import procgen as tprocgen
from rust_raytracer_torch.utils.metrics import RenderMetrics

from test_torch_scene import assert_compilers_equal, jax_graph, package
from test_torch_vertex import Tables, pack_roots, read_closure, read_program

torch.set_num_threads(2)

WIDTH, SPP, LANES, SEED = 16, 4, 2048, 2 ** 31 + 29
ROOT = Path(spec.ROOT)
STUB_OBJ = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 1 2 4\nf 1 3 4\nf 2 3 4\n"


@pytest.fixture
def no_obj(monkeypatch, tmp_path):
    """An asset root without resource/monkey.obj: the stand-in Suzanne."""
    monkeypatch.setattr(tbuiltin, "ASSET_ROOT", str(tmp_path))


@pytest.fixture
def small_knot(monkeypatch, no_obj):
    """The stand-in knot cut to perfbench/tests/small.py's size in the port
    (the reference's scene module is told the same size by the cell)."""
    orig = tprocgen.torus_knot_mesh
    monkeypatch.setattr(tprocgen, "torus_knot_mesh", lambda m, **k: orig(m, **{**k, **KNOT}))


@pytest.fixture
def stub_obj(monkeypatch, tmp_path):
    """A 4-triangle resource/monkey.obj under the asset root of both
    packages."""
    (tmp_path / "resource").mkdir()
    (tmp_path / "resource" / "monkey.obj").write_text(STUB_OBJ)
    for g in (jax_graph(), tg):
        monkeypatch.setattr(package(g, "models.builtin"), "ASSET_ROOT", str(tmp_path))


def _cell(monkeypatch):
    cell = small_cell("monkey_render", monkeypatch)
    orig = tprocgen.torus_knot_mesh   # small_cell's partial; the port names its sizes
    monkeypatch.setattr(tprocgen, "torus_knot_mesh", lambda m, **k: orig(m, **{**k, **KNOT}))
    return cell


def _limit():
    return spec.load_cell("monkey_render").limits["pixel_mismatch_share"]


def _camera(width=WIDTH, spp=SPP):
    cfg = spec.load_cell("monkey_render").config
    return tcamera.Camera(**{**cfg["camera"], "image_width": width}, samples_per_pixel=spp,
                          max_depth=cfg["max_depth"], light_bias=cfg["light_bias"])


def _compiled(name="golden_monkey"):
    return tcompiler.compile_scene(tmodels.build(name), "cpu")


# ---------------------------------------------------------------- the scene


def test_reference_scene_imports_neither_program_nor_jax():
    banned = {"rust_raytracer_torch", "rust_raytracer_tpu", "jax", "jaxlib", "flax"}
    tree = ast.parse((ROOT / "perfbench" / "scenes" / "golden_monkey.py").read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert not {n.split(".")[0] for n in names} & banned, names


def test_standin_without_obj(no_obj):
    """Without the OBJ the port's golden_monkey holds the 15,744-triangle
    knot in about Suzanne's box at her place, clear of the floor, beside
    the seeded field of 461 spheres, 418 materials, an 838-node program
    and the sky and sun as lights."""
    assert not os.path.exists(os.path.join(tbuiltin.ASSET_ROOT, "resource", "monkey.obj"))
    pack, static = _compiled()
    real = pack.tri_attr[:, 3:9].abs().sum(1) > 0
    assert int(real.sum()) == 2 * 164 * 48 == 15744
    v0 = pack.tri_attr[real, 0:3]
    lo, hi = v0.amin(0), v0.amax(0)
    np.testing.assert_allclose((hi - lo).numpy(), [2.69, 1.94, 1.71], atol=0.05)
    assert float(lo[1]) > 0.0 and abs(float((lo[1] + hi[1]) / 2) - 1.0) < 0.1
    assert pack.sph_center.shape[0] == 461 and pack.mat_type.shape[0] == 418
    kinds = [n.kind for n in static.tex_program]
    assert len(kinds) == 838 and kinds.count(ttex.CHECKER) == 1
    assert static.light_list == ((tpack.LIGHT_SKY, 0), (tpack.LIGHT_SUN, 0))
    f, i = vertex.table_arrays(pack, static)   # the 838-node program: no bound on it
    assert int(i[vertex.H_NNODE]) == 838


def test_with_obj_leaf_equal_jax(stub_obj):
    """With an OBJ the port's golden_monkey is the scene it was: compiled
    leaf for leaf equal to the JAX package's."""
    jax_scene, port_scene = (package(g, "models").build("golden_monkey")
                             for g in (jax_graph(), tg))
    assert_compilers_equal(jax_scene, port_scene)


# ---------------------------------------------------------------- closures


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(pack, static) of golden_monkey and perlin (whose closures share a
    Lerp over a NoiseSolid), each with a stub OBJ."""
    root = tmp_path_factory.mktemp("assets")
    (root / "resource").mkdir()
    (root / "resource" / "monkey.obj").write_text(STUB_OBJ)
    mp = pytest.MonkeyPatch()
    mp.setattr(tbuiltin, "ASSET_ROOT", str(root))
    try:
        return {name: _compiled(name) for name in ("golden_monkey", "perlin")}
    finally:
        mp.undo()


@pytest.mark.parametrize("name", ["golden_monkey", "perlin"])
def test_closures_complete_and_topological(scenes, name):
    """Each shading key's closure holds exactly the nodes its roots reach
    (worked out here by recursion), ascending (the program's topological
    order), and its table entries name each child by its position in it."""
    pack, static = scenes[name]
    program = static.tex_program
    t = Tables(pack, static)
    n_keys = pack.mat_type.shape[0] + pack.sky_tex.shape[0] + pack.sun_tex.shape[0]
    rows = t.irows(vertex.H_I_CLOS, n_keys, vertex.CLOS_I)
    shared = 0

    def reach(k, out):
        out.add(k)
        for c in program[k].children:
            reach(c, out)
        return out

    for key in range(n_keys):
        roots = pack_roots(pack, key)
        want = set()
        for r in roots:
            if r is not None:
                reach(r, want)
        entries = t.i[rows[key, 0]:rows[key, 0] + rows[key, 1] * vertex.CLOS_E].reshape(
            -1, vertex.CLOS_E)
        nodes = entries[:, 0].tolist()
        assert nodes == sorted(want), key
        assert len(nodes) <= vertex.MAX_NODES
        for p, k in enumerate(nodes):
            kids = program[k].children
            assert all(c < k for c in kids)
            assert [nodes[q] for q in entries[p, 1:1 + len(kids)]] == list(kids)
            assert all(q < p for q in entries[p, 1:1 + len(kids)])
        assert [None if q < 0 else nodes[q] for q in rows[key, 2:6]] == list(roots)
        shared += any(program[k].kind != ttex.CONSTANT and program[k].children
                      for k in nodes)
    if name == "perlin":
        kinds = {program[k].kind for k in range(len(program))}
        assert {ttex.LERP, ttex.NOISE_SOLID} <= kinds and shared >= 2


@pytest.mark.parametrize("name", ["golden_monkey", "perlin"])
def test_closure_reader_equals_eval_program(scenes, name):
    """The tables read as the shading kernel reads them (each key's closure
    alone, a numpy loop a lane) give every key's root values bit for bit
    as the numpy loop over the whole program (the kernel's reading before
    the closures), at random uv and pos, and as ops/texture.py:
    eval_program's whole program: bit for bit on golden_monkey (constants
    and a checker), within test_torch_vertex.py's 1e-6 on perlin, whose
    noise numpy rounds apart from torch's CPU kernels in the last place
    (on the card scripts/kv2_closure_check.py holds KV2 to the plain
    shading bit for bit)."""
    pack, static = scenes[name]
    t = Tables(pack, static)
    rng = np.random.default_rng(22)
    n = 24
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    pos = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    want = ttex.eval_program(static.tex_program, pack.tex_data, torch.from_numpy(uv),
                             torch.from_numpy(pos), tex_const=pack.tex_const).numpy()
    n_keys = pack.mat_type.shape[0] + pack.sky_tex.shape[0] + pack.sun_tex.shape[0]
    keys = range(n_keys) if name == "perlin" else sorted(set(range(0, n_keys, 7))
                                                          | {1, n_keys - 2, n_keys - 1})
    for lane in range(n):
        whole = read_program(t, uv[lane], pos[lane])
        for key in keys:
            got = read_closure(t, key, uv[lane], pos[lane])
            for value, root in zip(got, pack_roots(pack, key)):
                assert (value is None) == (root is None)
                if root is None:
                    continue
                np.testing.assert_array_equal(value, whole[root])
                if name == "golden_monkey":
                    np.testing.assert_array_equal(value, want[root, lane])
                else:
                    np.testing.assert_allclose(value, want[root, lane], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- the reference


def _reference_sums(seed, spp=SPP, width=WIDTH):
    cell = spec.load_cell("monkey_render")
    cell.config["camera"]["image_width"] = width
    cell.config.update(knot_rings=KNOT["rings"], knot_segments=KNOT["segments"])
    ref = check.Reference(cell, "cpu", spp)
    n = ref.camera.image_width * ref.camera.image_height
    return ref.pixel_sums(np.arange(n), [seed], spp)[0]


def _program_image(seed, spp=SPP, width=WIDTH, metrics=None, scene=None):
    film = Renderer(scene or tmodels.build("golden_monkey"), _camera(width, spp), seed=seed,
                    batch_size=LANES, device="cpu").render(mode="pool", metrics=metrics)
    return film.accum.reshape(-1, 3)


def test_reference_render_equals_program_on_monkey(small_knot):
    """Every pixel of a 24x16, 4-spp pool render of golden_monkey (the
    aperture, glass, metal, glossy spheres, the sky and the sun) against
    the reference's sums of the same samples, under the cell's camera."""
    ref = _reference_sums(7, width=24)
    got = _program_image(7, width=24)
    gaps = check.pixel_mismatch(got[None], ref[None])
    assert gaps["pixel_mismatch_share"] <= _limit(), gaps
    assert float(np.abs(got - ref).mean()) <= 1e-4 * float(np.abs(ref).mean())


# ---------------------------------------------------------------- faults


def _edit_scene(monkeypatch, edit):
    """models.build returning golden_monkey with `edit(scene)` applied."""
    orig = tmodels.build

    def build(name):
        scene = orig(name)
        edit(scene)
        return scene

    monkeypatch.setattr(tmodels, "build", build)


def _spheres(scene):
    return [s for s in scene.world.items[2].items if isinstance(s, tg.Sphere)]


def _glass_ior(monkeypatch):
    """The glass spheres at IOR 1.4 in place of 1.5."""
    def edit(scene):
        for s in _spheres(scene):
            if isinstance(s.material, tg.Dielectric):
                s.material.ior = 1.4
    _edit_scene(monkeypatch, edit)


def _sun_dropped(monkeypatch):
    """The sun left out of the light list (it still shines where a path
    meets it)."""
    def edit(scene):
        scene.lights = [x for x in scene.lights if not isinstance(x, tg.Sun)]
    _edit_scene(monkeypatch, edit)


def _aperture_off(monkeypatch):
    """A pinhole camera in place of the f/2.8 lens."""
    orig = tcamera.Camera
    monkeypatch.setattr(tcamera, "Camera", lambda **k: orig(**{**k, "f_number": None}))


def swapped_sphere(spheres, position):
    """(the glossy sphere nearest `position`, the glossy sphere whose albedo
    is farthest from its own): the pair whose albedos the fault swaps."""
    glossy = [s for s in spheres if type(s.material).__name__ == "Glossy"]
    near = min(glossy, key=lambda s: np.linalg.norm(np.subtract(s.center, position)))
    far = max(glossy, key=lambda s: np.linalg.norm(np.subtract(
        s.material.albedo.value, near.material.albedo.value)))
    return near, far


def _albedo_swapped(monkeypatch):
    """The albedos of the glossy sphere nearest the camera and of the
    glossy sphere whose albedo is farthest from its own swapped."""
    position = spec.load_cell("monkey_render").config["camera"]["position"]

    def edit(scene):
        a, b = swapped_sphere(_spheres(scene), position)
        a.material.albedo, b.material.albedo = b.material.albedo, a.material.albedo
    _edit_scene(monkeypatch, edit)


FAULTS = [_glass_ior, _sun_dropped, _aperture_off, _albedo_swapped]


def _zoom(cell, sphere_at):
    """The cell's camera aimed from nearby at a point (both sides run it)."""
    at = np.asarray(sphere_at, float)
    cell.config["camera"].update(position=(at + [0.9, 0.35, 1.2]).tolist(),
                                 look_at=at.tolist())


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_planted_monkey_fault_is_not_correct(fault, monkeypatch, no_obj):
    """Each fault planted in the program fails the comparison: the cell's
    view at the small cut, or, for the one swapped sphere (a few pixels of
    the frame at this cut), the same camera moved up to that sphere."""
    cell = _cell(monkeypatch)
    if fault is _albedo_swapped:
        spheres = _spheres(tbuiltin.golden_monkey())
        _zoom(cell, swapped_sphere(spheres, cell.config["camera"]["position"])[0].center)
    fault(monkeypatch)
    res = run.run_cell(cell, SEED, 0.05, False, device="cpu")
    assert res["correct"] is False, res["checks"]


def test_sound_monkey_run_is_correct(monkeypatch, no_obj):
    cell = _cell(monkeypatch)
    res = run.run_cell(cell, SEED, 0.05, False, device="cpu")
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["render_pixel_samples_per_s"]["value"] > 0


# ---------------------------------------------------------------- the counter


def test_sphere_hits_counts_the_plain_paths_sphere_hits(monkeypatch, small_knot):
    """RenderMetrics.sphere_hits of a pool render equals the PRIM_SPHERE
    hits of live lanes that the plain vertex's `intersect` returned; a
    second render of the same Renderer counts the same."""
    seen = []
    orig = tisect.intersect

    def intersect(pack, org, dirn, t_min, ctx, alive=None, **k):
        out = orig(pack, org, dirn, t_min, ctx, alive=alive, **k)
        hit = out[0] if isinstance(out, tuple) else out
        seen.append(int(((hit.kind == tpack.PRIM_SPHERE) & alive).sum()))
        return out

    monkeypatch.setattr(tisect, "intersect", intersect)
    r = Renderer(tmodels.build("golden_monkey"), _camera(), seed=5, batch_size=LANES,
                 device="cpu")
    counts = []
    for _ in range(2):
        metrics = RenderMetrics(n_pixels=r.camera.image_width * r.camera.image_height,
                                spp=SPP, max_depth=20)
        r.render(mode="pool", metrics=metrics)
        counts.append(metrics.sphere_hits)
        assert metrics.summary()["sphere_hits"] == metrics.sphere_hits
    assert counts[0] == counts[1] == sum(seen) // 2 > 0


def test_sphere_hits_is_the_same_over_lane_counts_and_shards(small_knot):
    pack, static = _compiled()
    cam = _camera()
    n_pixels = cam.image_width * cam.image_height
    counts = []
    for lanes, mesh in ((LANES, None), (LANES // 2, None),
                        (LANES, tmesh.make_mesh(2, device="cpu"))):
        metrics = RenderMetrics(n_pixels=n_pixels, spp=SPP, max_depth=20)
        tpool.run_pool(pack, static, cam, n_pixels, SPP, lanes, "cpu", seed=5,
                       metrics=metrics, mesh=mesh)
        counts.append(metrics.sphere_hits)
    assert counts[0] == counts[1] == counts[2] > 0


def test_sphere_hits_graphed_equals_eager(small_knot):
    """The counter through a (stand-in) graphed step whose capture's warm-up
    runs the step once more: equal to the eager step's, step for step."""
    cam = _camera()
    pack, static = _compiled()
    n_pixels = cam.image_width * cam.image_height
    eager = tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, 3)
    inner = tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, 3)
    capture = lambda body, device: types.SimpleNamespace(replay=body)  # noqa: E731
    graphed = tgraphs.GraphedStep(inner, capture=capture, counters=inner.counters)
    a = b = tpool.init_state(LANES, n_pixels, "cpu")
    row = lambda step: int(step.counters[0][vertex.ROW_SPHERE].sum())  # noqa: E731
    for _ in range(6):
        a, b = eager(pack, a), graphed(pack, b)
        assert row(eager) == row(inner)
    assert row(eager) > 0


def test_scene_without_spheres_has_no_sphere_counter():
    """cornell_smoke has no sphere: its steps add nothing to their counters'
    sphere row and a render records sphere_hits as None (the reader then
    reads nothing)."""
    scene = tmodels.build("cornell_smoke")
    pack, static = tcompiler.compile_scene(scene, "cpu")
    assert pack.sph_center.shape[0] == 0
    cam = _camera()
    n_pixels = cam.image_width * cam.image_height
    step = tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, 0)
    (counters,) = step.counters
    metrics = RenderMetrics(n_pixels=n_pixels, spp=SPP, max_depth=20)
    tpool.run_pool(pack, static, cam, n_pixels, SPP, LANES, "cpu", metrics=metrics, step=step)
    assert int(counters[vertex.ROW_SPHERE].sum()) == 0
    assert metrics.sphere_hits is None and "sphere_hits" not in metrics.summary()


# ---------------------------------------------------------------- readers

NEW_READERS = ("sphere_hit_pct.render", "analytic_hit_ms.render",
               "analytic_hit_roofline_pct.render", "shade_roofline_pct.render")


def _reader(name):
    return spec.metric_reader(name)


def _ctx(trace, counters):
    units = [Unit(0.0, 1.0, 100, True, c) for c in counters]
    return types.SimpleNamespace(trace=trace, traced_units=units, units=units,
                                 sizes={"lanes": 1024, "triangles": 0})


def _trace(ivs, window=1.0):
    return DeviceTrace(window_s=window, intervals={0: ivs}, host=[], devices=(0,))


STEP = [(0.00, 0.01, "vertex_hit_kernel(float const*)"),
        (0.01, 0.02, "bvh8_traverse_kernel(float const*)"),
        (0.02, 0.05, "vertex_shade_kernel(float const*)"),
        (0.05, 0.06, "lane_update_kernel(float const*)")]
LATER = [(a + 0.1, b + 0.1, n) for a, b, n in STEP]


def test_new_readers_none_where_absent():
    """No trace, no such kernel, no counter (a program without it, or a
    scene without spheres): each new reader reads nothing."""
    counters = [RenderMetrics(lane_bounces=1000)]
    for name in NEW_READERS:
        assert _reader(name)(_ctx(None, counters)) is None, name
    for name in NEW_READERS[1:]:
        assert _reader(name)(_ctx(_trace(STEP[1:2] + STEP[3:]), counters)) is None, name
    old = types.SimpleNamespace(lane_bounces=1000)   # a program without the counter
    assert _reader("sphere_hit_pct.render")(_ctx(None, [old])) is None


def test_new_readers_arithmetic():
    counters = [RenderMetrics(lane_bounces=4000, sphere_hits=600),
                RenderMetrics(lane_bounces=6000, sphere_hits=400)]
    ctx = _ctx(_trace(STEP + LATER), counters)
    assert _reader("sphere_hit_pct.render")(ctx) == pytest.approx(10.0)
    assert _reader("analytic_hit_ms.render")(ctx) == pytest.approx(1e3 * 0.02 / 2)
    assert _reader("analytic_hit_roofline_pct.render")(ctx) == pytest.approx(
        100.0 * (10000 * 45 / HBM_BYTES_PER_S) / 0.02)
    assert _reader("shade_roofline_pct.render")(ctx) == pytest.approx(
        100.0 * (10000 * 109 / HBM_BYTES_PER_S) / 0.06)
