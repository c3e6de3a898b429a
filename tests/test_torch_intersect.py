"""Port intersection (rust_raytracer_torch/ops/intersect.py, ops/bvh8.py)
against the JAX package.

The BVH8 traversal's plain version (the CUDA kernel's CPU counterpart) is
held against the JAX BVH8 Pallas kernel in interpret mode and against the
JAX threaded walk (kernel="jnp") with the cases of tests/test_pallas.py:
equal hit masks, t at rtol 2e-5 / atol 1e-6, slot agreement >= 0.999 (equal-t
ties may break differently).  Full `intersect` / `hit_attributes` on primary
and bounce rays: kind and prim agree on >= 0.999 of lanes, t and attributes
at rtol 1e-5 / atol 1e-6 where they agree."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytracer_tpu.core import rng as jrng
from rust_raytracer_tpu.ops import intersect as jisect
from rust_raytracer_tpu.ops import pallas_bvh8 as pb8
from rust_raytracer_tpu.scene import compiler as jcompiler
from rust_raytracer_tpu.utils import config as cfg
from rust_raytracer_torch.ops import bvh8 as tbvh8
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.render import camera as tcam
from rust_raytracer_torch.render import renderer as trenderer

from rust_raytracer_torch.scene import graph as tg

from test_torch_scene import (jax_graph, mini_dragon_scene, port_pack_from_jax, soup_scene,
                              texture_scene)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def soup():
    jp, _ = jcompiler.compile_scene(soup_scene(jax_graph()))
    return jp, port_pack_from_jax(jp)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    dirn = rng.normal(size=(n, 3)).astype(np.float32)
    return org, dirn


def _hold(t_got, i_got, t_want, i_want):
    hit_got, hit_want = i_got >= 0, i_want >= 0
    np.testing.assert_array_equal(hit_got, hit_want)
    np.testing.assert_allclose(t_got[hit_got], t_want[hit_want], rtol=2e-5, atol=1e-6)
    assert (i_got[hit_got] == i_want[hit_want]).mean() >= 0.999


def _run_all(soup, org, dirn, t_max):
    jp, tp = soup
    t_min = jnp.full((org.shape[0],), 1e-3, jnp.float32)
    ja = [jnp.asarray(org), jnp.asarray(dirn), t_min, jnp.asarray(t_max)]
    k1 = pb8.intersect_triangles_bvh8(jp, *ja, interpret=True)
    walk = jisect.intersect_triangles(jp, *ja, kernel="jnp")
    calls = tbvh8.plain_calls
    got = tbvh8.intersect_triangles_bvh8(tp, torch.from_numpy(org), torch.from_numpy(dirn),
                                         None, torch.from_numpy(t_max))
    assert tbvh8.plain_calls == calls + 1
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    got = tuple(x.numpy() for x in got)
    return got, tuple(np.asarray(x) for x in k1), tuple(np.asarray(x) for x in walk)


@pytest.mark.parametrize("n,seed", [(384, 3), (pb8.TILE + 9, 7)])
def test_bvh8_plain_matches_jax(soup, n, seed):
    org, dirn = _rays(n, seed)
    t_max = np.full((n,), np.inf, np.float32)
    got, k1, walk = _run_all(soup, org, dirn, t_max)
    assert (got[1] >= 0).sum() >= 16
    _hold(*got, *k1)
    _hold(*got, *walk)
    np.testing.assert_array_equal(got[0][got[1] < 0], np.inf)  # t == t_max on a miss


def test_bvh8_plain_respects_finite_tmax(soup):
    n = pb8.TILE + 9
    org, dirn = _rays(n, 7)
    (t_ref, i_ref), _, _ = _run_all(soup, org, dirn, np.full((n,), np.inf, np.float32))
    cap = np.where(i_ref >= 0, t_ref * 0.5, 1.0).astype(np.float32)
    cap[::2] = np.inf
    got, k1, walk = _run_all(soup, org, dirn, cap)
    _hold(*got, *k1)
    _hold(*got, *walk)
    np.testing.assert_array_equal(got[1][::2] >= 0, i_ref[::2] >= 0)
    assert not np.any(got[1][1::2] >= 0)
    np.testing.assert_array_equal(got[0][got[1] < 0], cap[got[1] < 0])


def test_bvh8_plain_dead_lanes(soup):
    n = 384
    org, dirn = _rays(n, 3)
    got, k1, walk = _run_all(soup, org, dirn, np.zeros((n,), np.float32))
    assert (got[1] < 0).all() and (k1[1] < 0).all() and (walk[1] < 0).all()
    np.testing.assert_array_equal(got[0], 0.0)


def test_bvh8_wrapper_rejects_bad_inputs(soup):
    _, tp = soup
    org = torch.zeros((8, 3))
    with pytest.raises(TypeError):
        tbvh8.intersect_triangles_bvh8(tp, org.double(), org, None, torch.zeros(8))
    with pytest.raises(ValueError):
        tbvh8.intersect_triangles_bvh8(tp, org, org, None, torch.zeros(7))


def _scene_rays(name, n_primary=768, n_bounce=768):
    """(JAX pack, port pack, org, dirn): primary camera rays plus a bounce
    wavefront from the primary hits (a few aimed at the sun)."""
    scene = {"mini_dragon": mini_dragon_scene, "texture": texture_scene}[name](jax_graph())
    jp, _ = jcompiler.compile_scene(scene)
    tp = port_pack_from_jax(jp)
    sc = cfg.merge_scene_config(scene.config, {"output_width": 32})
    cam = tcam.camera_from_config(sc, cfg.RenderConfig(samples_per_pixel=1))
    rng = np.random.default_rng(5)
    px = torch.from_numpy(rng.integers(0, cam.image_width, n_primary))
    py = torch.from_numpy(rng.integers(0, cam.image_height, n_primary))
    smp = torch.zeros_like(px)
    org, dirn = cam.generate_rays(px, py, smp, _tctx(py * cam.image_width + px))
    hit = tisect.intersect(tp, org, dirn, 1e-3, _tctx(py * cam.image_width + px))
    t = torch.where(torch.isfinite(hit.t), hit.t, torch.ones_like(hit.t))
    org2 = (org + dirn * t[:, None])[:n_bounce]
    d2 = rng.normal(size=(n_bounce, 3)).astype(np.float32)
    if jp.sun_dir.shape[0]:
        d2[:64] = np.asarray(jp.sun_dir[0])
    org = torch.cat([org, org2]).numpy()
    dirn = np.concatenate([dirn.numpy(), d2])
    return jp, tp, org, dirn


def _tctx(pixel):
    from rust_raytracer_torch.core import rng as trng

    return trng.Ctx(pixel, torch.zeros_like(pixel), 0, 0)


@pytest.mark.parametrize("name", ["mini_dragon", "texture"])
def test_intersect_and_hit_attributes_match(name):
    jp, tp, org, dirn = _scene_rays(name)
    n = org.shape[0]
    jctx = jrng.Ctx(jnp.arange(n, dtype=jnp.uint32), jnp.zeros(n, jnp.uint32),
                    jnp.uint32(0), jnp.uint32(0))
    jo, jd = jnp.asarray(org), jnp.asarray(dirn)
    jhit = jisect.intersect(jp, jo, jd, 1e-3, jctx, kernel="jnp")
    jattr = jisect.hit_attributes(jp, jo, jd, jhit)
    to, td = torch.from_numpy(org), torch.from_numpy(dirn)
    thit = tisect.intersect(tp, to, td, 1e-3, _tctx(torch.arange(n)))
    tattr = tisect.hit_attributes(tp, to, td, thit)

    kinds = set(np.asarray(jhit.kind).tolist())
    assert {3} <= kinds if name == "mini_dragon" else {1, 2, 3, 5, 6} <= kinds
    agree = (thit.kind.numpy() == np.asarray(jhit.kind)) & (
        thit.prim.numpy() == np.asarray(jhit.prim))
    assert agree.mean() >= 0.999, agree.mean()
    jt, tt = np.asarray(jhit.t)[agree], thit.t.numpy()[agree]
    np.testing.assert_array_equal(np.isfinite(tt), np.isfinite(jt))
    fin = np.isfinite(jt)
    np.testing.assert_allclose(tt[fin], jt[fin], rtol=1e-5, atol=1e-6)
    for field in tattr._fields:
        got = getattr(tattr, field).numpy()[agree]
        want = np.asarray(getattr(jattr, field))[agree]
        if got.dtype == bool or field == "mat":
            np.testing.assert_array_equal(got, want, err_msg=field)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=field)


def test_unported_kernels_raise():
    """Every traversal is ported: the port's kernel names, and the
    reference's portable "jnp" walk, are accepted; the reference's "pallas"
    is an unknown name here.  Volumes are ported too: `intersect` runs
    `cornell_smoke` (two box volumes) and some of its rays stop in a volume,
    the same with "jnp" as with "auto"."""
    for kernel in ("auto", "bvh8", "threaded", "wavefront", "jnp"):
        assert tisect.check_kernel(kernel) is None  # ported: accepted
    for kernel in ("pallas",):
        with pytest.raises(ValueError, match="unknown kernel"):
            tisect.check_kernel(kernel)
    from rust_raytracer_torch import models as tmodels
    from rust_raytracer_torch.core import rng as trng
    from rust_raytracer_torch.scene import compiler as tcompiler
    from rust_raytracer_torch.scene import pack as tpack

    pack, _ = tcompiler.compile_scene(tmodels.build("cornell_smoke"), "cpu")
    n = 512
    rng = np.random.default_rng(2)
    org = torch.from_numpy(rng.uniform(-20, 20, (n, 3)).astype(np.float32))
    dirn = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    ctx = trng.Ctx(torch.arange(n), torch.zeros(n, dtype=torch.int64), 0, 0)
    hit = tisect.intersect(pack, org, dirn, 1e-3, ctx)
    for a, b in zip(hit, tisect.intersect(pack, org, dirn, 1e-3, ctx, kernel="jnp")):
        assert torch.equal(a, b)
    vol = hit.kind == tpack.PRIM_VOLUME
    assert vol.any()
    attr = tisect.hit_attributes(pack, org, dirn, hit)
    assert attr.valid[vol].all() and torch.isfinite(attr.pos[vol]).all()
    assert (pack.mat_type[attr.mat[vol].long()] == tpack.MAT_ISOTROPIC).all()


def test_renderer_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-fallback rule is moot here")
    scene = mini_dragon_scene(tg)
    cam = tcam.camera_from_config(
        cfg.merge_scene_config(scene.config, {"output_width": 8}), cfg.RenderConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        trenderer.Renderer(scene, cam, device="cuda")


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from rust_raytracer_torch.ops import _cuda

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_cuda, "LIB_PATH", tmp_path / "librrt_kernels.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tbvh8.build_library()
    built = set()
    for src in _cuda.sources():
        cmd = _cuda.nvcc_command("nvcc", src, tmp_path / f"{src.stem}.o")
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-fmad=false" in cmd and "--use_fast_math" not in cmd
        assert cmd[-1] == str(src) and "-c" in cmd
        built.add(src.name)
    assert {"bvh8_traverse.cu", "threaded_traverse.cu", "wf_cull.cu", "wf_compact.cu",
            "wf_mt.cu"} <= built
