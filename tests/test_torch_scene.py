"""The port's JAX-free scene front end against the JAX package's: the two
compilers (with the port's own copies of the graph, BVH builder, BVH8
collapse, native builder and models) give equal ScenePack leaves in shape,
dtype and value and an equal SceneStatic; the kernel tables against the
reference layouts; a JAX-package scene refused by the port; and a
subprocess that renders with `jax` and `rust_raytracer_tpu` blocked.

Each scene is built once in each package: the builtins through each
package's `models.build`, the hand-built helpers here (mini cornell_dragon,
texture scene, triangle soup; shared by the other tests/test_torch_*.py
files) from the graph module they are given.  This module imports the JAX
package only inside functions, so the blocked subprocess can import the
helpers."""
import dataclasses
import functools
import importlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from rust_raytracer_torch.ops import bvh8 as tbvh8
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.scene import pack as tpack

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_graph():
    """The JAX package's scene graph module."""
    from rust_raytracer_tpu.scene import graph

    return graph


def package(g, name):
    """Module `name` (e.g. "models.builtin") of the package that graph
    module `g` belongs to."""
    return importlib.import_module(f"{g.__name__.split('.')[0]}.{name}")


# ---------------------------------------------------------------- scenes

def mini_dragon_scene(g):
    """cornell_dragon cut to size: the Cornell shell, floor and light of
    models/builtin.py:265-276 around a 960-triangle torus knot, built with
    graph module `g`."""
    builtin, procgen = package(g, "models.builtin"), package(g, "utils.procgen")
    mat_white, walls = builtin._cornell_shell()
    mat_light = g.Emissive(g.Constant((15.0, 15.0, 15.0)))
    mat_gloss = g.Glossy(g.Constant((0.73, 0.73, 0.73)), g.Constant(0.0), 1.5)
    floor = g.Plane((277.5, 0, 277.5), (277.5, 0, 0), (0, 0, -277.5), mat_white)
    light = g.Plane((277.5, 554.9, 277.5), (-130, 0, 0), (0, 0, -105), mat_light,
                    render_backface=True)
    mesh = procgen.torus_knot_mesh(mat_gloss, rings=40, segments=12)
    knot = g.Transform(mesh).scale(110).rotate_y(225).translate(267.5, 200.0, 277.5)
    return g.SceneDef(world=g.Group([floor] + walls + [light, knot]), lights=[light],
                      config=dict(builtin._CORNELL_CONFIG))


# tests/_grad_fd_main.py's probe: 16x16 pixels, 1 spp, depth 3, seed 7, and
# the tables whose gradients it checks
PROBE_DEPTH, PROBE_LANES, PROBE_SEED = 3, 256, 7
PROBED = ("sph_center", "sph_radius", "pln_corner", "background", "tex_const")


def probe_scene(g):
    """tests/_grad_fd_main.py's scene, built with graph module `g`: a
    diffuse ball on a diffuse floor lit by an emissive quad and a dim sky."""
    light = g.Plane((0, 2.0, 0), (0.8, 0, 0), (0, 0, 0.8),
                    g.Emissive(g.Constant((6.0, 6.0, 6.0))))
    floor = g.Plane((0, -0.4, 0), (-4, 0, 0), (0, 0, 4),
                    g.Lambertian(g.Constant((0.6, 0.6, 0.6))))
    ball = g.Sphere((0, 0, 0), 0.35, g.Lambertian(g.Constant((0.7, 0.2, 0.2))))
    sky = g.Sky(g.Constant((0.1, 0.1, 0.1)))
    return g.SceneDef(world=g.Group([ball, floor, light, sky]),
                      lights=[light, sky], config={})


def probe_camera(camera_cls):
    """tests/_grad_fd_main.py's camera, of class `camera_cls`."""
    return camera_cls(image_width=16, aspect_ratio=1.0, samples_per_pixel=1,
                      max_depth=PROBE_DEPTH, position=(0, 0.3, 1.6), look_at=(0, 0, 0),
                      focal_length=35.0)


def _image(h, w, seed):
    return np.random.default_rng(seed).uniform(size=(h, w, 3)).astype(np.float32)


def texture_scene(g):
    """Every texture class of scene/graph.py (Checker, CheckerSolid, Image,
    Lerp, NoiseSolid(Perlin(seed=7)) with both maps, Channel, UvDebug), a
    normal map, every surface material, a textured uv mesh, sphere / plane /
    proxy / sky / sun lights; built with graph module `g`."""
    c = g.Constant
    noise = g.NoiseSolid(g.Perlin(seed=7), scale=2.0)
    turb = g.NoiseSolid(g.Perlin(seed=7), scale=0.5, samples=5, map="turbulence")
    img = g.Image(_image(16, 24, 1))
    img_clamp = g.Image(_image(8, 8, 2), clamp=True)
    nmap = g.Image(_image(8, 12, 3))
    checker = g.Checker(c((0.2, 0.3, 0.1)), c((0.9, 0.9, 0.9)), 0.1)
    solid = g.CheckerSolid(c((0.8, 0.1, 0.1)), c((0.1, 0.1, 0.8)), 0.3)
    lerp = g.Lerp(c((0.02, 0.02, 0.03)), c((0.9, 0.9, 0.9)), noise)
    chan = g.Channel(g.Lerp(img, solid, turb), 1)

    floor = g.Plane((0, -1, 0), (-6, 0, 0), (0, 0, 6), g.Lambertian(checker))
    back = g.Plane((0, 1, -4), (4, 0, 0), (0, 2, 0), g.Lambertian(g.UvDebug()))
    s_img = g.Sphere((-1.5, 0, 0), 0.8, g.Glossy(img, c(0.3), 1.5, normal_map=nmap))
    s_solid = g.Sphere((0.3, -0.3, 0.6), 0.6, g.Metal(solid, chan))
    s_marble = g.Sphere((1.6, 0, -0.5), 0.9, g.Lambertian(lerp))
    s_glass = g.Sphere((0.2, 0.9, 1.2), 0.4, g.Dielectric(1.5))
    s_iso = g.Sphere((-0.6, 1.4, -1.0), 0.35, g.Isotropic(turb))
    s_dbg = g.Sphere((1.8, 1.5, 0.8), 0.3, g.NormalDebug(normal_map=nmap))
    s_light = g.Sphere((0, 3, 0), 0.5, g.Emissive(c((6.0, 5.0, 4.0))))
    p_light = g.Plane((-2, 2.5, 1), (0.5, 0, 0), (0, 0, 0.5),
                      g.Emissive(c((3.0, 3.0, 3.0))), render_backface=True)
    quad = g.Mesh(
        vertices=np.array([[-1, -0.9, 1.5], [1, -0.9, 1.5], [1, 0.6, 2.0], [-1, 0.6, 2.0]],
                          np.float64),
        normals=np.zeros((0, 3)), uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64),
        triangles=np.array([[[0, 0, 0], [1, 0, 1], [2, 0, 2]],
                            [[0, 0, 0], [2, 0, 2], [3, 0, 3]]], np.int32),
        material=g.Glossy(img_clamp, c(0.2), 1.4, normal_map=nmap),
        flat_shading=True, hit_back_faces=True,
    )
    sky = g.Sky(c((0.3, 0.4, 0.6)))
    sun = g.Sun((-1.0, 1.0, 0.5), c((8.0, 8.0, 8.0)))
    proxy = g.ProxySphereLight((2.0, 2.0, 2.0), 0.5)
    world = g.Group([floor, back, s_img, s_solid, s_marble, s_glass, s_iso, s_dbg,
                     s_light, p_light, quad, sky, sun])
    return g.SceneDef(
        world=world, lights=[s_light, p_light, proxy, sky, sun],
        config=dict(output_width=24, aspect_ratio=1.5, focal_length=35.0,
                    camera_pos=(0.0, 1.0, 7.0), camera_target=(0.0, 0.0, 0.0),
                    background=(0.05, 0.05, 0.1)),
    )


def soup_scene(g):
    """The random triangle soup of tests/test_pallas.py, built with graph
    module `g`."""
    rng = np.random.default_rng(11)
    n_tris = 700
    centers = rng.uniform(-1, 1, (n_tris, 3))
    offsets = rng.normal(0, 0.12, (n_tris, 3, 3))
    verts = (centers[:, None, :] + offsets).reshape(-1, 3)
    tris = np.arange(3 * n_tris).reshape(n_tris, 3)
    tri_idx = np.stack([tris, tris, np.full_like(tris, -1)], axis=-1)
    mesh = g.Mesh(
        vertices=verts, normals=np.zeros((0, 3)), uvs=np.zeros((0, 2)),
        triangles=tri_idx, material=g.Lambertian(g.Constant((0.5, 0.5, 0.5))),
    )
    return g.SceneDef(world=g.Group([mesh]), lights=[])


def builtin_scene(name, g):
    """Builtin scene `name` from the models registry of `g`'s package."""
    return package(g, "models").build(name)


# name -> builder taking a graph module
SCENES = {
    "test": functools.partial(builtin_scene, "test"),
    "cornell": functools.partial(builtin_scene, "cornell"),
    "cornell_smoke": functools.partial(builtin_scene, "cornell_smoke"),
    "tonemap_test": functools.partial(builtin_scene, "tonemap_test"),
    "soup": soup_scene,
    "texture": texture_scene,
    "mini_dragon": mini_dragon_scene,
}


def jax_leaves(pack):
    """numpy leaves of a JAX ScenePack (name -> array) and its tex_data."""
    leaves = {f.name: np.asarray(getattr(pack, f.name))
              for f in dataclasses.fields(pack) if f.name != "tex_data"}
    return leaves, tuple(np.asarray(d) for d in pack.tex_data)


def port_pack_from_jax(pack, device="cpu"):
    """Feed a JAX-compiled scene to the port (as numpy, never as jax)."""
    leaves, tex_data = jax_leaves(pack)
    return tpack.from_numpy(leaves, tex_data, device)


def port_static(static):
    """The JAX SceneStatic with the port's TexNode class."""
    from rust_raytracer_torch.ops import texture as ttex

    return tcompiler.SceneStatic(
        tex_program=tuple(ttex.TexNode(**dataclasses.asdict(n)) for n in static.tex_program),
        light_list=static.light_list)


# ---------------------------------------------------------------- tests

def test_pack_fields_match_reference():
    from rust_raytracer_tpu.scene import pack as jpack

    want = {f.name for f in dataclasses.fields(jpack.ScenePack)}
    assert set(tpack.LEAF_FIELDS) | {"tex_data"} == want
    assert len(tpack.LEAF_FIELDS) == len(want) - 1


def test_empty_pack_matches_reference():
    """empty_pack: every field of the reference's empty_pack(float32) in
    shape and dtype (the f64 case is in tests/test_torch_f64.py), and the
    port's pack of it on the CPU with empty kernel tables."""
    from rust_raytracer_tpu.scene import pack as jpack

    want = jpack.empty_pack()
    got = tpack.empty_leaves(np.float32)
    assert set(got) == set(tpack.LEAF_FIELDS)
    for f in tpack.LEAF_FIELDS:
        w = np.asarray(getattr(want, f))
        assert (got[f].shape, got[f].dtype) == (w.shape, w.dtype), f
    assert want.tex_data == ()
    p = tpack.empty_pack()
    assert p.dtype == torch.float32 and p.tex_data == () and p.bvh8_depth == 0
    assert p.tri_rows.shape == (0, 12) and p.bvh_node_rows.shape == (0, 8)


def assert_compilers_equal(jax_scene, port_scene):
    """Both compilers on the same scene, built once in each package: every
    leaf equal in shape, dtype and value, SceneStatic equal."""
    from rust_raytracer_tpu.scene import compiler as jcompiler

    jp, js = jcompiler.compile_scene(jax_scene)
    want, want_tex = jax_leaves(jp)
    got, got_tex, static = tcompiler.compile_numpy(port_scene)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got_tex) == len(want_tex)
    for a, b in zip(got_tex, want_tex):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert static.light_list == js.light_list
    assert ([dataclasses.astuple(n) for n in static.tex_program]
            == [dataclasses.astuple(n) for n in js.tex_program])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compile_scene_leaves_equal_jax(name):
    assert_compilers_equal(SCENES[name](jax_graph()), SCENES[name](tg))


@pytest.mark.parametrize("name", ["cornell", "test", "cornell_dragon"])
def test_builtins_leaves_equal_jax(name, monkeypatch):
    """The builtins the port's tests and smoke run use, through each
    package's own `models.build`: compiled leaves equal.  cornell_dragon
    with its torus knot cut to 40 x 12 rings in both packages (the BVH8
    collapse and the native SAH builder run on it)."""
    for g in (jax_graph(), tg):
        procgen = package(g, "utils.procgen")
        monkeypatch.setattr(procgen, "torus_knot_mesh", functools.partial(
            procgen.torus_knot_mesh, rings=40, segments=12))
    jax_scene, port_scene = (builtin_scene(name, g) for g in (jax_graph(), tg))
    assert_compilers_equal(jax_scene, port_scene)


def test_jax_scene_def_raises_type_error():
    """A SceneDef of the JAX package's graph is refused with a TypeError
    that names the port's graph, not compiled to something else."""
    with pytest.raises(TypeError, match="rust_raytracer_torch.scene.graph"):
        tcompiler.compile_numpy(builtin_scene("cornell", jax_graph()))
    with pytest.raises(TypeError, match="SceneDef"):
        tcompiler.compile_scene(object(), "cpu")


@pytest.mark.parametrize("name", ["mini_dragon", "texture"])
def test_from_numpy_round_trip(name):
    from rust_raytracer_tpu.scene import compiler as jcompiler

    jp, _ = jcompiler.compile_scene(SCENES[name](jax_graph()))
    leaves, tex_data = jax_leaves(jp)
    pack = tpack.from_numpy(leaves, tex_data, "cpu").to("cpu")
    assert pack.device == torch.device("cpu")
    assert set(tpack.DEVICE_FIELDS) | set(tpack.HOST_ONLY_FIELDS) == set(tpack.LEAF_FIELDS)
    assert not set(tpack.HOST_ONLY_FIELDS) & set(pack._fields)
    for k in tpack.DEVICE_FIELDS:
        t = getattr(pack, k)
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), leaves[k], err_msg=k)
    for t, d in zip(pack.tex_data, tex_data):
        np.testing.assert_array_equal(t.numpy(), d)


@pytest.mark.parametrize("name", ["mini_dragon", "soup"])
def test_bvh8_kernel_tables(name):
    leaves, _, _ = tcompiler.compile_numpy(SCENES[name](tg))
    pack = tpack.from_numpy(leaves, (), "cpu")
    aabb8, child8 = leaves["bvh8_aabb"], leaves["bvh8_child"]
    np.testing.assert_array_equal(pack.bvh8_box.numpy(), aabb8[:, :, 0:6])
    np.testing.assert_array_equal(child8, aabb8[:, :, 6].astype(np.int32))
    geom = leaves["tri_geom"]
    rows = pack.tri_rows.numpy().reshape(geom.shape[0], 128, 12)
    np.testing.assert_array_equal(rows[:, :, 0:10], geom[:, 0:10, :].transpose(0, 2, 1))
    np.testing.assert_array_equal(rows[:, :, 10:], 0.0)

    def depth(node):
        kids = [c for c in child8[node] if c > 0]
        return 1 + max((depth(c) for c in kids), default=0)

    assert pack.bvh8_depth == depth(0)
    assert 8 * pack.bvh8_depth + 1 <= tbvh8.STACK

    # the leaf test's tables: each cluster's rows permuted, each with its
    # slot, padding (zero edges) last; every real triangle's float box
    # inside its group's box; a group of padding alone inverted
    leaf, gbox = pack.bvh8_leaf_rows.numpy(), pack.bvh8_leaf_box.numpy()
    nc = geom.shape[0]
    assert leaf.dtype == np.float32 and leaf.shape == (nc * 128, 12)
    assert gbox.dtype == np.float32 and gbox.shape == (nc, 4, 6)
    leaf = leaf.reshape(nc, 128, 12)
    perm = leaf.view(np.int32)[..., 10].astype(np.int64)
    np.testing.assert_array_equal(np.sort(perm, axis=1), np.broadcast_to(np.arange(128), (nc, 128)))
    np.testing.assert_array_equal(leaf[..., 0:10],
                                  np.take_along_axis(rows, perm[..., None], 1)[..., 0:10])
    np.testing.assert_array_equal(leaf[..., 11], 0.0)
    real = (rows[:, :, 3:9] != 0).any(-1)
    assert real.any() and (~real).any()
    real_p = np.take_along_axis(real, perm, axis=1)
    assert not (~real_p[:, :-1] & real_p[:, 1:]).any()
    v0, e1, e2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    verts = np.stack([v0, v0 + e1, v0 + e2], axis=2)
    group = np.argsort(perm, axis=1) // 32                      # each slot's group
    box = np.take_along_axis(gbox, group[..., None], axis=1)    # (nc, 128, 6)
    assert (verts.min(2)[real] >= box[real][:, 0:3]).all()
    assert (verts.max(2)[real] <= box[real][:, 3:6]).all()
    empty = ~real_p.reshape(nc, 4, 32).any(-1)
    assert empty.any() and (~empty).any()
    assert (gbox[empty][:, 0:3] > gbox[empty][:, 3:6]).all()
    assert (gbox[~empty][:, 0:3] <= gbox[~empty][:, 3:6]).all()


@pytest.mark.parametrize("name", ["mini_dragon", "soup"])
def test_threaded_node_rows(name):
    """The threaded kernel's 32-byte node rows hold the reference's
    (M, 16) `bvh_rows`: boxes bit for bit, the miss link, and the hit link
    or -(cluster + 1) at a leaf, whose hit link is its miss link."""
    leaves, _, _ = tcompiler.compile_numpy(SCENES[name](tg))
    rows = tpack.from_numpy(leaves, (), "cpu").bvh_node_rows.numpy()
    ref = leaves["bvh_rows"]
    assert rows.shape == (ref.shape[0], 8) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, 0:6], ref[:, 0:6])
    links = rows.view(np.int32)
    leaf = ref[:, 8] > 0
    assert leaf.any() and (~leaf).any()
    np.testing.assert_array_equal(links[:, 6], ref[:, 7].astype(np.int32))
    np.testing.assert_array_equal(ref[leaf, 6], ref[leaf, 7])
    np.testing.assert_array_equal(links[~leaf, 7], ref[~leaf, 6].astype(np.int32))
    np.testing.assert_array_equal(links[leaf, 7], -ref[leaf, 8].astype(np.int32))


def test_port_runs_without_jax(tmp_path):
    """Import every module of rust_raytracer_torch with `jax` and the JAX
    package blocked (the walk covers the CLI, the DSL, the importers,
    metrics, checkpoint and parallel.mesh), then build the mini scene with
    the port's own graph, config and models, render a 16x16 frame on the
    CPU in both modes and in batch mode on a 2-shard CPU mesh, and run the
    CLI on the CPU on cornell_smoke (volumes)."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["rust_raytracer_tpu"] = None
        sys.path.insert(0, {REPO!r})
        sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
        import numpy as np, torch
        torch.set_num_threads(2)
        import rust_raytracer_torch
        walked = set()
        for m in pkgutil.walk_packages(rust_raytracer_torch.__path__, "rust_raytracer_torch."):
            importlib.import_module(m.name)
            walked.add(m.name[len("rust_raytracer_torch."):])
        want = {{"__main__", "utils.cli", "utils.config", "scene.dsl", "utils.gltf", "utils.fbx",
                "utils.collada", "utils.model_import", "utils.metrics", "render.checkpoint",
                "parallel.mesh"}}
        assert want <= walked, want - walked
        from rust_raytracer_torch import models
        from rust_raytracer_torch.scene import graph
        from rust_raytracer_torch.utils import config as cfg
        from rust_raytracer_torch.render.camera import camera_from_config
        from rust_raytracer_torch.render.renderer import Renderer
        from test_torch_scene import mini_dragon_scene
        assert "cornell_dragon" in models.names()
        scene = mini_dragon_scene(graph)
        sc = cfg.merge_scene_config(scene.config, {{"output_width": 16}})
        cam = camera_from_config(sc, cfg.RenderConfig(samples_per_pixel=1, max_depth=4))
        r = Renderer(scene, cam, batch_size=256, device="cpu")
        for mode in ("pool", "batch"):
            img = r.render(mode=mode).hdr()
            assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0
        from rust_raytracer_torch.parallel import mesh as pmesh
        rm = Renderer(scene, cam, batch_size=256, device="cpu",
                      mesh=pmesh.make_mesh(2, device="cpu"))
        assert np.array_equal(rm.render(mode="batch").hdr(), img)
        from rust_raytracer_torch.utils import cli
        out = {str(tmp_path / "smoke.png")!r}
        assert cli.main(["cornell_smoke", "-w=12", "-s=1", "--max-depth=3", "-o=" + out],
                        device="cpu") == 0
        loaded = [k for k, v in sys.modules.items() if v is not None and (
            k.split(".")[0] in ("jax", "rust_raytracer_tpu"))]
        assert not loaded, loaded
        print("ok", img.mean())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-1].startswith("ok")  # the CLI logs to stdout before it
    assert (tmp_path / "smoke.png").exists()
