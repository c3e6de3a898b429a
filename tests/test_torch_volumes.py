"""Volumes in the port (rust_raytracer_torch/ops/intersect.py:
`_volume_boundary_span`, `intersect_volumes`, their place in `intersect`, the
volume branch of `hit_attributes`) against the JAX package's (kernel="jnp").

Three scenes cover the three boundary kinds: the builtin `cornell_smoke`
(two oriented boxes), a sphere and an ellipsoid volume, and a convex-mesh
volume pair (a sheared box and an octahedron, so one block is padded).
Rays are numpy-seeded: random origins and directions around the volumes,
256 of them axis-parallel (the box slab divides by zero there).

Tolerances, measured on the CPU at 4096 rays: kind and prim agree on every
ray (required >= 0.999); t within 2.3e-7 relative (required rtol 1e-5,
atol 1e-6); attributes within 1.9e-6 absolute at positions up to 30
(required rtol 1e-5, atol 2e-6); integer and bool fields equal.  Small pool renders (24x24, 16 spp, depth 8): mean |d| / mean
<= 4e-8 and every pixel within rtol 1e-3 / atol 1e-4 (required <= 1e-3 and
>= 99.5%, the pool image test of test_torch_render.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytracer_tpu.core import rng as jrng
from rust_raytracer_tpu.ops import intersect as jisect
from rust_raytracer_tpu.render.renderer import Renderer as JRenderer
from rust_raytracer_tpu.scene import compiler as jcompiler
from rust_raytracer_tpu.utils import config as cfg
from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.render import camera as tcam
from rust_raytracer_torch.render.renderer import Renderer as TRenderer
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.scene import pack as tpack

from test_torch_scene import jax_graph, mini_dragon_scene, package, port_pack_from_jax

torch.set_num_threads(2)

N_RAYS = 4096


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one intra-op thread.  With two, a process's first
    torch.sqrt over 4096 elements has returned the second thread's half
    (rows 2048-4095) at ~12-bit precision on the CPU (relative error
    3.1e-4; the same call again was exact), which t's rtol of 1e-5
    catches.  One thread computes every row as the later calls do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fog_config():
    return dict(output_width=24, aspect_ratio=1.0, focal_length=35.0,
                camera_pos=(0.0, 0.5, 7.0), camera_target=(0.0, 0.0, 0.0),
                background=(0.1, 0.1, 0.15))


def _room(g):
    white = g.Lambertian(g.Constant((0.73, 0.73, 0.73)))
    light = g.Sphere((0, 4, 0), 0.8, g.Emissive(g.Constant((8.0, 8.0, 8.0))))
    floor = g.Plane((0, -1, 0), (-6, 0, 0), (0, 0, 6), white)
    return white, g.Isotropic(g.Constant((0.8, 0.8, 0.8))), floor, light


def sphere_volume_scene(g):
    """A sphere volume and an ellipsoid one (a non-uniformly scaled,
    rotated sphere: VOL_SPHERE with a general world -> unit-sphere map)."""
    white, iso, floor, light = _room(g)
    sph = g.Volume(g.Sphere((-1.2, 0.2, 0), 0.9, white), iso, 0.6)
    ell = g.Transform(g.Sphere((0, 0, 0), 0.7, white))
    ell.scale(1.6, 0.8, 1.0).rotate_z(25).translate(1.3, 0.3, 0.2)
    return g.SceneDef(world=g.Group([floor, light, sph, g.Volume(ell, iso, 0.9)]),
                      lights=[light], config=_fog_config())


def octahedron(g, center, r, material):
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                     np.float64) * r + np.asarray(center, np.float64)
    faces = np.array([(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
                      (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)])
    tris = np.stack([faces, np.zeros_like(faces), np.full_like(faces, -1)], axis=-1)
    return g.Mesh(vertices=verts, normals=np.zeros((0, 3)), uvs=np.zeros((0, 2)),
                  triangles=tris.astype(np.int32), material=material)


def mesh_volume_scene(g):
    """Two convex-mesh volumes: a box rotated then scaled non-uniformly (a
    sheared box, 12 triangles) and an octahedron Mesh (8, padded to 12)."""
    white, iso, floor, light = _room(g)
    shear = g.Transform(g.Box((0, 0, 0), (1.2, 1.2, 1.2), white))
    shear.rotate_z(30).scale(1.5, 1.0, 1.0).translate(-1.2, 0.2, 0)
    octa = octahedron(g, (1.3, 0.2, 0.3), 0.9, white)
    return g.SceneDef(world=g.Group([floor, light, g.Volume(shear, iso, 0.7),
                                     g.Volume(octa, iso, 1.1)]),
                      lights=[light], config=_fog_config())


def smoke_scene(g):
    return package(g, "models").build("cornell_smoke")


SCENES = {"cornell_smoke": smoke_scene, "sphere": sphere_volume_scene,
          "mesh": mesh_volume_scene}
KINDS = {"cornell_smoke": (tpack.VOL_BOX,) * 2, "sphere": (tpack.VOL_SPHERE,) * 2,
         "mesh": (tpack.VOL_MESH,) * 2}
TRI_COUNTS = {"cornell_smoke": (0, 0), "sphere": (0, 0), "mesh": (12, 8)}


def _packs(name):
    jp, _ = jcompiler.compile_scene(SCENES[name](jax_graph()))
    return jp, port_pack_from_jax(jp)


def _rays(name, n=N_RAYS, seed=3):
    rng = np.random.default_rng(seed)
    scale = 30.0 if name == "cornell_smoke" else 3.0
    org = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    dirn = rng.normal(size=(n, 3)).astype(np.float32)
    k = np.arange(256)
    dirn[:256] = 0.0
    dirn[k, k % 3] = np.where(k % 2, 1.0, -1.0)  # axis-parallel rays
    return org, dirn


def _ctxs(n, bounce=0, seed=0):
    jctx = jrng.Ctx(jnp.arange(n, dtype=jnp.uint32), jnp.zeros(n, jnp.uint32),
                    jnp.uint32(bounce), jnp.uint32(seed))
    tctx = trng.Ctx(torch.arange(n), torch.zeros(n, dtype=torch.int64), bounce, seed)
    return jctx, tctx


@pytest.mark.parametrize("name", sorted(SCENES))
def test_intersect_and_hit_attributes_match_jax(name):
    jp, tp = _packs(name)
    assert tp.vol_kinds == KINDS[name] and tp.vol_tri_counts == TRI_COUNTS[name]
    org, dirn = _rays(name)
    jctx, tctx = _ctxs(org.shape[0], bounce=2, seed=5)
    jo, jd = jnp.asarray(org), jnp.asarray(dirn)
    jhit = jisect.intersect(jp, jo, jd, 1e-3, jctx, kernel="jnp")
    jattr = jisect.hit_attributes(jp, jo, jd, jhit)
    to, td = torch.from_numpy(org), torch.from_numpy(dirn)
    thit = tisect.intersect(tp, to, td, 1e-3, tctx)
    tattr = tisect.hit_attributes(tp, to, td, thit)

    jkind = np.asarray(jhit.kind)
    assert (jkind == tpack.PRIM_VOLUME).sum() >= 100
    assert set(np.asarray(jhit.prim)[jkind == tpack.PRIM_VOLUME].tolist()) == {0, 1}
    agree = (thit.kind.numpy() == jkind) & (thit.prim.numpy() == np.asarray(jhit.prim))
    assert agree.mean() >= 0.999, agree.mean()
    jt, tt = np.asarray(jhit.t)[agree], thit.t.numpy()[agree]
    np.testing.assert_array_equal(np.isfinite(tt), np.isfinite(jt))
    fin = np.isfinite(jt)
    np.testing.assert_allclose(tt[fin], jt[fin], rtol=1e-5, atol=1e-6)
    vol = thit.kind.numpy()[agree] == tpack.PRIM_VOLUME
    for field in tattr._fields:
        got = getattr(tattr, field).numpy()[agree]
        want = np.asarray(getattr(jattr, field))[agree]
        if got.dtype == bool or field == "mat":
            np.testing.assert_array_equal(got, want, err_msg=field)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6, err_msg=field)
    # the volume branch: normal (1, 0, 0) before the front-face flip
    n_vol = tattr.normal.numpy()[agree][vol]
    np.testing.assert_array_equal(np.abs(n_vol), np.tile([1.0, 0.0, 0.0], (len(n_vol), 1)))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_boundary_spans_match_jax(name):
    """The span of each volume, every ray, against the JAX span (vmapped as
    intersect_volumes calls it): valid masks equal; enter and exit within
    rtol 1e-5 / atol 1e-5 where valid, NaN where JAX's is (the box slab on
    axis-parallel rays)."""
    jp, tp = _packs(name)
    org, dirn = _rays(name)
    span = jax.vmap(jisect._volume_boundary_span, in_axes=(None, 0, 0, None))
    for vi in range(len(tp.vol_kinds)):
        want = [np.asarray(x) for x in span(jp, jnp.asarray(org), jnp.asarray(dirn), vi)]
        got = [x.numpy() for x in tisect._volume_boundary_span(
            tp, torch.from_numpy(org), torch.from_numpy(dirn), vi)]
        np.testing.assert_array_equal(got[2], want[2])
        assert want[2].sum() >= 50
        for g_, w_ in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(np.isnan(g_), np.isnan(w_))
            v = want[2]
            np.testing.assert_allclose(g_[v], w_[v], rtol=1e-5, atol=1e-5)


def test_free_flight_draw_matches_jax():
    """Volume vi's draw, ctx.uniform(Streams.VOLUME + 16 * vi), equals the
    JAX package's bit for bit at several bounces and seeds."""
    n = 2048
    for bounce, seed in ((0, 0), (3, 7), (19, 12345)):
        jctx, tctx = _ctxs(n, bounce, seed)
        for vi in range(3):
            stream = trng.Streams.VOLUME + 16 * vi
            np.testing.assert_array_equal(tctx.uniform(stream).numpy(),
                                          np.asarray(jctx.uniform(stream)))


def test_mesh_span_chunked_equals_whole(monkeypatch):
    """The mesh span in many triangle chunks (two passes) equals the span of
    the whole block bit for bit."""
    _, tp = _packs("mesh")
    org, dirn = (torch.from_numpy(a) for a in _rays("mesh"))
    whole = [tisect._volume_boundary_span(tp, org, dirn, vi) for vi in range(2)]
    monkeypatch.setattr(tisect, "VOL_CHUNK_ELEMS", org.shape[0] * 5)  # chunks of 5 of 12
    for vi in range(2):
        for a, b in zip(tisect._volume_boundary_span(tp, org, dirn, vi), whole[vi]):
            assert torch.equal(a, b)


def test_scene_without_volumes_adds_nothing(monkeypatch):
    """A pack without volumes never reaches the volume code."""
    jp, _ = jcompiler.compile_scene(mini_dragon_scene(jax_graph()))
    tp = port_pack_from_jax(jp)
    assert tp.vol_kinds == ()

    def boom(*a, **k):
        raise AssertionError("volume code ran for a scene without volumes")

    monkeypatch.setattr(tisect, "intersect_volumes", boom)
    monkeypatch.setattr(tisect, "_volume_boundary_span", boom)
    org, dirn = (torch.from_numpy(a) for a in _rays("sphere", n=256))
    _, tctx = _ctxs(256)
    hit = tisect.intersect(tp, org, dirn, 1e-3, tctx)
    assert not (hit.kind == tpack.PRIM_VOLUME).any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_small_render_matches_jax(name):
    """A 24x24, 16 spp, depth 8 pool render of the port against JAX's
    (kernel="jnp"), held as test_torch_render.py holds its pool image."""
    scene = SCENES[name](tg)
    sc = cfg.merge_scene_config(scene.config, {"output_width": 24})
    rc = cfg.RenderConfig(samples_per_pixel=16, max_depth=8)
    want = JRenderer(SCENES[name](jax_graph()), cfg.make_camera(sc, rc), batch_size=1024,
                     kernel="jnp").render(mode="pool").hdr()
    got = TRenderer(scene, tcam.camera_from_config(sc, rc), batch_size=1024,
                    device="cpu").render(mode="pool").hdr()
    assert got.shape == want.shape and np.isfinite(got).all() and got.mean() > 0
    rel = np.abs(got - want).mean() / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    assert rel <= 1e-3, rel
    assert close >= 0.995, close
