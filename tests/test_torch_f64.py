"""The f64 validation dtype of the port against the JAX package's.

The JAX side runs in a subprocess with JAX_ENABLE_X64=1
(tests/_torch_f64_jax_main.py, as tests/_grad_fd_main.py runs), so x64 mode
never leaks into the f32 suite.  On tests/_grad_fd_main.py's scene (and the
mini cornell_dragon for the pack) the port's f64 pack equals the
reference's leaf for leaf, its f64 trace equals the reference's radiance
within 1e-10 relative, its autograd gradients equal the reference's
analytic ones within rtol 1e-7, and its own central differences meet
tests/test_grad.py's tolerance.  The f32 functions of the RNG's f32
uniforms are computed as the reference's CPU build computes them
(core/math.py:cos_sin32), which is what lets the two f64 traces agree to
~1e-14 rather than to f32's last bit."""
import ctypes
import ctypes.util
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from rust_raytracer_torch.core import math as tmath
from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.render import integrator as tintegrator
from rust_raytracer_torch.render import pool as tpool
from rust_raytracer_torch.render.camera import Camera as TCamera
from rust_raytracer_torch.render.renderer import Renderer as TRenderer
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.scene import pack as tpack

from test_torch_scene import (PROBE_DEPTH, PROBE_LANES, PROBE_SEED, PROBED, mini_dragon_scene,
                              probe_camera, probe_scene)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
F64 = torch.float64


@pytest.fixture(scope="module")
def jax_f64(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("f64") / "jax_f64.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(HERE, os.pardir)]
                                        + env.get("PYTHONPATH", "").split(os.pathsep))
    run = subprocess.run([sys.executable, os.path.join(HERE, "_torch_f64_jax_main.py"), out],
                         capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _hold_leaves(jax_f64, prefix, leaves, tex_data):
    for f in tpack.LEAF_FIELDS:
        want, got = jax_f64[f"{prefix}/{f}"], leaves[f]
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)
    jtex = sorted(k for k in jax_f64 if k.startswith(f"{prefix}/tex_data/"))
    assert len(jtex) == len(tex_data)
    for i, d in enumerate(tex_data):
        want = jax_f64[f"{prefix}/tex_data/{i}"]
        assert d.dtype == want.dtype
        np.testing.assert_array_equal(d, want)


@pytest.mark.parametrize("name", ["probe", "dragon"])
def test_f64_pack_equals_jax(jax_f64, name):
    """compile_numpy(scene, float64): every leaf of the reference's f64 pack
    in dtype and value — the f64 geometry, materials and lights, and the
    f32 traversal tables (bvh_rows, tri_geom, bvh8_aabb, wf_*) of the mini
    cornell_dragon.  The pack on the CPU keeps each leaf's dtype, and its
    kernel tables stay f32."""
    scene = probe_scene(tg) if name == "probe" else mini_dragon_scene(tg)
    leaves, tex_data, _ = tcompiler.compile_numpy(scene, np.float64)
    _hold_leaves(jax_f64, name, leaves, tex_data)
    pack, _ = tcompiler.compile_scene(scene, "cpu", F64)
    assert pack.dtype == F64 and pack.tri_v0.dtype == F64 and pack.wf_cl_lo.dtype == torch.float32
    assert pack.tri_rows.dtype == pack.bvh_node_rows.dtype == torch.float32


def test_empty_pack_f64_equals_jax(jax_f64):
    """empty_pack(float64): the reference's fields, shapes and dtypes."""
    _hold_leaves(jax_f64, "empty", tpack.empty_leaves(np.float64), ())
    p = tpack.empty_pack(F64)
    assert p.dtype == F64 and p.tri_v0.shape == (0, 3) and p.tex_const.dtype == F64


def test_cos_sin32_equals_libm():
    """core/math.py:cos_sin32 equals the C library's cosf and sinf (which
    the reference's CPU build calls for f32 cos and sin) bit for bit on
    20,000 sampling angles 2 pi u, their negatives and the edges of its
    branches; sqrt32 is the correctly rounded f32 sqrt."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("cosf", "sinf"):
        getattr(libm, name).restype = ctypes.c_float
        getattr(libm, name).argtypes = [ctypes.c_float]
    u = np.random.default_rng(3).random(10000).astype(np.float32)
    phi = (u * np.float32(2.0) * np.float32(np.pi)).astype(np.float32)
    edges = np.array([0.0, 1e-40, 2.0 ** -12, 2.0 ** -13, 0.78, 0.785, 0.7853982, 0.7854,
                      np.pi / 2, np.pi, 1.5 * np.pi, 2 * np.pi, 6.2831855, 119.9, 130.0],
                     np.float32)
    angles = np.concatenate([phi, -phi, edges, -edges])
    cos, sin = tmath.cos_sin32(torch.from_numpy(angles))
    np.testing.assert_array_equal(cos.numpy(), [libm.cosf(float(a)) for a in angles])
    np.testing.assert_array_equal(sin.numpy(), [libm.sinf(float(a)) for a in angles])
    np.testing.assert_array_equal(tmath.sqrt32(torch.from_numpy(u)).numpy(), np.sqrt(u))


def _probe():
    pack, static = tcompiler.compile_scene(probe_scene(tg), "cpu", F64)
    cam = probe_camera(TCamera)
    ar = torch.arange(PROBE_LANES)
    px, py = ar % cam.image_width, (ar // cam.image_width) % cam.image_height
    smp = torch.zeros_like(ar)
    ctx = trng.Ctx(pixel=py * cam.image_width + px, sample=smp, bounce=0, seed=PROBE_SEED)
    org, dirn = cam.generate_rays(px, py, smp, ctx, F64)
    wgt = torch.cos(torch.arange(PROBE_LANES * 3, dtype=F64)).reshape(PROBE_LANES, 3)
    return pack, static, org, dirn, ctx, wgt


def _radiance(pack, static, org, dirn, ctx, **kw):
    return tintegrator.trace(pack, static, org, dirn, ctx, PROBE_DEPTH, 0.25, **kw)


def test_f64_trace_equals_jax(jax_f64):
    """The f64 trace (16x16, 1 spp, depth 3, kernel "auto" -> "jnp") against
    the reference's f64 radiance within 1e-10 relative, every lane; f64
    through, no f32 left in the result."""
    pack, static, org, dirn, ctx, _ = _probe()
    assert org.dtype == dirn.dtype == F64
    rad = _radiance(pack, static, org, dirn, ctx)
    assert rad.dtype == F64
    want = jax_f64["radiance"]
    assert want.dtype == np.float64 and np.abs(want).max() > 0
    np.testing.assert_allclose(rad.numpy(), want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("remat", ["none", "hits", "full"])
def test_f64_gradients_equal_jax(jax_f64, remat):
    """Autograd gradients of _grad_fd_main.py's loss (sum of radiance times
    cos weights) with respect to its probed tables, in every remat mode,
    against the reference's analytic gradients: rtol 1e-7, atol 1e-9."""
    pack, static, org, dirn, ctx, wgt = _probe()
    gp = pack.with_grad()
    rad = _radiance(gp, static, org, dirn, ctx, differentiable=True, remat=remat)
    loss = (rad * wgt).sum()
    grads = torch.autograd.grad(loss, [getattr(gp, f) for f in PROBED])
    for f, g in zip(PROBED, grads):
        assert g.dtype == F64
        np.testing.assert_allclose(g.numpy(), jax_f64[f"grad/{f}"], rtol=1e-7, atol=1e-9,
                                   err_msg=f)
    assert max(float(np.abs(jax_f64[f"grad/{f}"]).max()) for f in PROBED) > 1e-3


def test_f64_central_differences():
    """The port's own central differences (eps 1e-6) of the f64 trace
    against its autograd gradients on every probe of _grad_fd_main.py
    (sphere center xyz and radius, the floor's corner y, background g, the
    four most sensitive tex_const entries): tests/test_grad.py's rtol 1e-3,
    atol 1e-5."""
    pack, static, org, dirn, ctx, wgt = _probe()
    gp = pack.with_grad()
    loss = (_radiance(gp, static, org, dirn, ctx, differentiable=True) * wgt).sum()
    grads = dict(zip(PROBED, torch.autograd.grad(loss, [getattr(gp, f) for f in PROBED])))

    def loss_at(field, idx, delta):
        arr = getattr(pack, field).clone()
        arr[idx] += delta
        return float((_radiance(pack._replace(**{field: arr}), static, org, dirn, ctx)
                      * wgt).sum())

    floor = int(torch.argmin(pack.pln_corner[:, 1]))
    probes = [("sph_center", (0, a)) for a in range(3)] + [
        ("sph_radius", (0,)), ("pln_corner", (floor, 1)), ("background", (1,))]
    cg = grads["tex_const"].numpy()
    for fi in np.argsort(-np.abs(cg).ravel())[:4]:
        idx = np.unravel_index(int(fi), cg.shape)
        if abs(cg[idx]) >= 1e-6:
            probes.append(("tex_const", tuple(int(i) for i in idx)))
    assert sum(f == "tex_const" for f, _ in probes) >= 2
    eps = 1e-6
    for field, idx in probes:
        fd = (loss_at(field, idx, eps) - loss_at(field, idx, -eps)) / (2 * eps)
        an = float(grads[field][idx])
        np.testing.assert_allclose(an, fd, rtol=1e-3, atol=1e-5, err_msg=f"{field}{idx}")


def test_f64_kernel_choice():
    """An f64 pack: "auto" resolves to "jnp" on the CPU; an explicit CUDA
    walk raises TypeError naming "jnp"; on CUDA even "auto" raises (the
    card never picks the plain walk unasked).  An f32 pack keeps its
    choice."""
    pack, _ = tcompiler.compile_scene(probe_scene(tg), "cpu", F64)
    assert tisect.resolve_kernel("auto", pack) == "jnp"
    assert tisect.resolve_kernel("jnp", pack) == "jnp"
    for k in ("bvh8", "threaded", "wavefront"):
        with pytest.raises(TypeError, match="jnp"):
            tisect.resolve_kernel(k, pack)
    on_card = types.SimpleNamespace(dtype=F64, device=torch.device("cuda", 0))
    for k in ("auto", "bvh8", "threaded", "wavefront"):
        with pytest.raises(TypeError, match="jnp"):
            tisect.resolve_kernel(k, on_card)
    assert tisect.resolve_kernel("jnp", on_card) == "jnp"
    f32, _ = tcompiler.compile_scene(probe_scene(tg), "cpu")
    assert tisect.resolve_kernel("auto", f32) == "auto"
    with pytest.raises(TypeError, match="jnp"):
        TRenderer(probe_scene(tg), probe_camera(TCamera), device="cpu", dtype=F64,
                  kernel="threaded")


def test_f64_renderer_pool_and_batch():
    """Renderer(dtype=float64) on the CPU: the pool (its state f64) and the
    batch schedule trace the same paths, so the images agree to f64 sum
    order."""
    r = TRenderer(probe_scene(tg), probe_camera(TCamera), batch_size=128, device="cpu",
                  dtype=F64)
    assert r.pack.dtype == F64
    pool, batch = r.render(mode="pool").hdr(), r.render(mode="batch").hdr()
    assert np.isfinite(pool).all() and pool.mean() > 0
    np.testing.assert_allclose(pool, batch, rtol=1e-12, atol=1e-14)
    state = tpool.init_state(8, 4, "cpu", F64)
    assert state.org.dtype == state.accum.dtype == F64
