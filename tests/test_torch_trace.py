"""The port's batch trace, batch render and differentiable trace
(rust_raytracer_torch/render/integrator.py:trace, renderer.render_batched)
against the JAX package, on the CPU.

Radiance comparisons are per lane: the port's arithmetic differs from
XLA's in the last ulp (tests/test_torch_render.py), and a rare edge hit
that flips on that drift changes one lane's whole path, so a small share of
lanes may differ while the rest agree closely.  Gradients are compared
leaf by leaf on the same pack, with the same loss, seed and rays.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytracer_tpu.core import rng as jrng
from rust_raytracer_tpu.render import camera as jcam_mod
from rust_raytracer_tpu.render import integrator as jint
from rust_raytracer_tpu.render.renderer import Renderer as JRenderer
from rust_raytracer_tpu.scene import compiler as jcompiler
from rust_raytracer_tpu.utils import config as jcfg
from rust_raytracer_torch import models as tmodels
from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.ops import threaded as tthr
from rust_raytracer_torch.render import camera as tcam
from rust_raytracer_torch.render import integrator as tint
from rust_raytracer_torch.render.renderer import BatchMetrics, Renderer as TRenderer
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.utils import config as tcfg

from test_torch_scene import jax_graph, mini_dragon_scene, port_pack_from_jax, port_static

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))


def _lanes_close(got, want, rtol=1e-4, atol=1e-5):
    """Share of lanes (rows) whose three channels agree, and mean |d| / mean."""
    close = np.isclose(got, want, rtol=rtol, atol=atol).all(axis=-1).mean()
    rel = np.abs(got - want).mean() / max(np.abs(want).mean(), 1e-12)
    return close, rel


def _camera_lanes(cam, n, spp=1):
    """Pixel-major lanes of the first n (pixel, sample) pairs."""
    flat = np.arange(n)
    pix, smp = flat // spp, flat % spp
    return pix % cam.image_width, pix // cam.image_width, smp


# ---------------------------------------------------------------- trace

@pytest.fixture(scope="module")
def mini():
    """The mini cornell_dragon compiled by JAX, the same pack in the port,
    and camera rays of 32x32 pixels at 1 spp from each package's camera."""
    scene = mini_dragon_scene(jax_graph())
    jp, js = jcompiler.compile_scene(scene)
    sc = jcfg.merge_scene_config(scene.config, {"output_width": 32})
    rc = jcfg.RenderConfig(samples_per_pixel=1, max_depth=4)
    jc, tc = jcfg.make_camera(sc, rc), tcam.camera_from_config(sc, rc)
    n = tc.image_width * tc.image_height
    px, py, smp = _camera_lanes(tc, n)
    jctx = jrng.Ctx(pixel=jnp.asarray(py * tc.image_width + px, jnp.uint32),
                    sample=jnp.asarray(smp, jnp.uint32), bounce=jnp.uint32(0),
                    seed=jnp.uint32(3))
    jo, jd = jc.generate_rays(jnp.asarray(px, jnp.uint32), jnp.asarray(py, jnp.uint32),
                              jnp.asarray(smp, jnp.uint32), jctx, jnp.float32)
    tpx, tpy, tsmp = (torch.from_numpy(a) for a in (px, py, smp))
    tctx = trng.Ctx(pixel=tpy * tc.image_width + tpx, sample=tsmp, bounce=0, seed=3)
    to, td = tc.generate_rays(tpx, tpy, tsmp, tctx)
    return dict(jp=jp, js=js, tp=port_pack_from_jax(jp), ts=port_static(js),
                jray=(jo, jd, jctx), tray=(to, td, tctx))


@pytest.mark.parametrize("compact", [True, False])
def test_trace_matches_jax(mini, compact):
    """Depth 4 through both traces, with and without compaction.  Measured:
    all 1024 lanes within rtol 1e-4 / atol 1e-5, mean |d| / mean 5.4e-8.
    Required: >= 0.99 of lanes within that tolerance (a path flip changes
    a whole lane) and mean |d| / mean <= 1e-3."""
    jo, jd, jctx = mini["jray"]
    want = np.asarray(jint.trace(mini["jp"], mini["js"], jo, jd, jctx, 4, 0.25,
                                 compact=compact, kernel="jnp"))
    to, td, tctx = mini["tray"]
    calls = tthr.plain_calls
    got = tint.trace(mini["tp"], mini["ts"], to, td, tctx, 4, 0.25, compact=compact,
                     kernel="threaded")
    assert 0 < tthr.plain_calls - calls <= 4  # one walk a bounce, early exit allowed
    assert got.shape == want.shape and not got.requires_grad
    got = got.numpy()
    assert np.isfinite(got).all() and (got > 0).any()
    close, rel = _lanes_close(got, want)
    assert close >= 0.99, close
    assert rel <= 1e-3, rel


def test_trace_compaction_and_kernel_change_nothing(mini):
    """The port's trace gives the same radiance bit for bit with and
    without compaction, and through either exact walk: the RNG is keyed by
    lane ids and every lane's arithmetic is its own."""
    to, td, tctx = mini["tray"]
    runs = [tint.trace(mini["tp"], mini["ts"], to, td, tctx, 4, 0.25, compact=c, kernel=k)
            for c, k in ((True, "threaded"), (False, "threaded"), (True, "bvh8"))]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])


# ---------------------------------------------------------------- batch render

def test_render_batch_matches_jax_and_batch_size():
    """render(mode="batch") of the mini scene at 16x16, 4 spp, depth 4,
    against the JAX package's render_batched (kernel="jnp"); and the
    port's image identical for batch sizes 1024 (one batch) and 300
    (four batches, the last padded by wrapping).  Measured against JAX:
    every pixel within rtol 1e-3 / atol 1e-4, mean |d| / mean 8.7e-8.
    Required: >= 0.99 of pixels, mean |d| / mean <= 1e-3."""
    scene = mini_dragon_scene(tg)
    sc = tcfg.merge_scene_config(scene.config, {"output_width": 16})
    rc = tcfg.RenderConfig(samples_per_pixel=4, max_depth=4)
    cam = tcam.camera_from_config(sc, rc)
    calls = tthr.plain_calls
    metrics = BatchMetrics()
    got = TRenderer(scene, cam, batch_size=1024, kernel="threaded",
                    device="cpu").render(mode="batch", metrics=metrics)
    assert metrics.batches == 1 and 0 < metrics.bounces <= 4
    assert tthr.plain_calls - calls == metrics.bounces  # one walk a bounce
    metrics = BatchMetrics()
    other = TRenderer(scene, cam, batch_size=300, kernel="threaded",
                      device="cpu").render(mode="batch", metrics=metrics)
    assert metrics.batches == 4
    np.testing.assert_array_equal(got.hdr(), other.hdr())
    assert got.samples == cam.actual_spp == 4
    jsc = jcfg.merge_scene_config(mini_dragon_scene(jax_graph()).config, {"output_width": 16})
    want = JRenderer(mini_dragon_scene(jax_graph()), jcfg.make_camera(jsc, rc), batch_size=1024,
                     kernel="jnp").render(mode="batch").hdr()
    close, rel = _lanes_close(got.hdr(), want, rtol=1e-3, atol=1e-4)
    assert close >= 0.99, close
    assert rel <= 1e-3, rel


def test_cornell_batch_render_matches_golden():
    """The port's batch render of cornell at 64 px / 49 spp / depth 20
    against the committed golden (the JAX package's batch render,
    tests/test_golden.py), with the bounds the pool render is held to
    (tests/test_torch_render.py, ROADMAP Queue 3): at most 48 pixels
    outside rtol = atol = 2e-4, each within one path of the light's
    radiance (15 / 49 + 2e-4), and mean |d| / mean <= 1e-3.  Measured:
    the pool render's numbers, 44 pixels outside, max |d| 0.3049, mean
    |d| / mean 6.0e-4."""
    scene = tmodels.build("cornell")
    sc = tcfg.merge_scene_config(scene.config, {"output_width": 64})
    cam = tcam.camera_from_config(sc, tcfg.RenderConfig(samples_per_pixel=49, max_depth=20))
    got = TRenderer(scene, cam, batch_size=1 << 16, device="cpu").render(mode="batch").hdr()
    ref = np.load(os.path.join(HERE, "golden", "cornell_64.npy"))
    got = got.astype(np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    outside = ~np.isclose(got, ref, rtol=2e-4, atol=2e-4).all(axis=-1)
    d = np.abs(got - ref).max(axis=-1)
    rel = np.abs(got - ref).mean() / ref.mean()
    assert outside.sum() <= 48, outside.sum()
    assert d.max() <= 15.0 / 49 + 2e-4, d.max()
    assert rel <= 1e-3, rel


# ---------------------------------------------------------------- gradients

DEPTH = 3
N_GRAD = 256  # 16x16 pixels x 1 spp, as tests/_grad_fd_main.py


def _probe_scene(g):
    """tests/_grad_fd_main.py's scene: a diffuse ball on a diffuse floor
    lit by an emissive quad and a dim sky."""
    light = g.Plane((0, 2.0, 0), (0.8, 0, 0), (0, 0, 0.8),
                    g.Emissive(g.Constant((6.0, 6.0, 6.0))))
    floor = g.Plane((0, -0.4, 0), (-4, 0, 0), (0, 0, 4),
                    g.Lambertian(g.Constant((0.6, 0.6, 0.6))))
    ball = g.Sphere((0, 0, 0), 0.35, g.Lambertian(g.Constant((0.7, 0.2, 0.2))))
    sky = g.Sky(g.Constant((0.1, 0.1, 0.1)))
    return g.SceneDef(world=g.Group([ball, floor, light, sky]), lights=[light, sky], config={})


_PROBE_CAMERA = dict(image_width=16, aspect_ratio=1.0, samples_per_pixel=1, max_depth=DEPTH,
                     position=(0, 0.3, 1.6), look_at=(0, 0, 0), focal_length=35.0)


def _probe_lanes(cam):
    """_grad_fd_main.py's lanes: pixels x, y at 1 spp and the loss's cos
    weights (N_GRAD, 3)."""
    w = cam.image_width
    px = np.arange(N_GRAD) % w
    py = (np.arange(N_GRAD) // w) % cam.image_height
    wgt = np.cos(np.arange(N_GRAD * 3, dtype=np.float64)).reshape(N_GRAD, 3).astype(np.float32)
    return px, py, wgt


def _port_loss(static, camera, compact=True):
    """_grad_fd_main.py's loss in the port, as a function of a port pack
    and a remat mode: the sum of radiance times cos weights over the
    probe lanes, traced differentiably through the threaded walk."""
    cam = tcam.Camera(**camera)
    px, py, wgt = _probe_lanes(cam)
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    sample = torch.zeros_like(tpx)
    ctx = trng.Ctx(pixel=tpy * cam.image_width + tpx, sample=sample, bounce=0, seed=7)

    def loss(pack, remat="hits"):
        org, dirn = cam.generate_rays(tpx, tpy, sample, ctx)
        rad = tint.trace(pack, static, org, dirn, ctx, DEPTH, 0.25, compact=compact,
                         differentiable=True, kernel="threaded", remat=remat)
        return (rad * torch.from_numpy(wgt)).sum()
    return loss


def _grads(jax_scene, fields, camera=_PROBE_CAMERA, remats=("hits",), compact=True,
           with_jax=True):
    """jax.grad and torch.autograd.grad of _grad_fd_main.py's loss, the
    sum of radiance times cos weights, on the same pack: returns
    (loss, grads by field) of JAX (None without `with_jax`) and of the
    port for each remat mode, and the port's loss function and pack."""
    jp, js = jcompiler.compile_scene(jax_scene)
    jc = jcam_mod.Camera(**camera)
    w = jc.image_width
    px, py, wgt = _probe_lanes(jc)

    def jloss(pack):
        jpx, jpy = jnp.asarray(px, jnp.uint32), jnp.asarray(py, jnp.uint32)
        sample = jnp.zeros((N_GRAD,), jnp.uint32)
        ctx = jrng.Ctx(pixel=jpy * np.uint32(w) + jpx, sample=sample,
                       bounce=jnp.uint32(0), seed=jnp.uint32(7))
        org, dirn = jc.generate_rays(jpx, jpy, sample, ctx, jnp.float32)
        rad = jint.trace(pack, js, org, dirn, ctx, DEPTH, 0.25, compact=compact,
                         differentiable=True, kernel="jnp")
        return jnp.sum(rad * jnp.asarray(wgt))

    want = None
    if with_jax:
        jl, jg = jax.value_and_grad(jloss, allow_int=True)(jp)
        want = (float(jl), {f: np.asarray(getattr(jg, f)) for f in fields})

    tp = port_pack_from_jax(jp).with_grad()
    loss_fn = _port_loss(port_static(js), camera, compact)
    got = {}
    for remat in remats:
        loss = loss_fn(tp, remat)
        gs = torch.autograd.grad(loss, [getattr(tp, f) for f in fields], allow_unused=True)
        got[remat] = (float(loss.detach()), {f: (np.zeros(getattr(tp, f).shape, np.float32)
                                        if g is None else g.numpy())
                                    for f, g in zip(fields, gs)})
    return want, got, loss_fn, tp


PROBE_FIELDS = ("sph_center", "sph_radius", "pln_corner", "background", "tex_const")


def _hold_grads(want, got, rtol, atol_frac):
    """Each field's port gradient finite everywhere and, where JAX's is
    finite, within rtol and atol_frac of the field's largest entry.
    Returns the worst |d| / max |g| over fields and the number of entries
    where JAX's gradient is not finite."""
    worst, jax_nonfinite = 0.0, 0
    for f, w in want[1].items():
        g = got[1][f]
        assert np.isfinite(g).all(), f
        fin = np.isfinite(w)
        jax_nonfinite += int((~fin).sum())
        scale = max(float(np.abs(w[fin]).max()), 1e-12)
        np.testing.assert_allclose(g[fin], w[fin], rtol=rtol, atol=atol_frac * scale, err_msg=f)
        worst = max(worst, float(np.abs(g[fin] - w[fin]).max()) / scale)
    return worst, jax_nonfinite


def test_grad_matches_jax():
    """The probe scene of tests/_grad_fd_main.py (16x16, depth 3, f32):
    the port's gradients of its loss against jax.grad's, for sph_center,
    sph_radius, pln_corner, background and tex_const.  Measured: loss rel
    8.1e-7, worst gradient error 7.4e-7 of the field's largest entry.
    Required: loss rel <= 1e-5; rtol 1e-3 and atol 1e-3 of the largest
    entry per field."""
    want, got, _, _ = _grads(_probe_scene(jax_graph()), PROBE_FIELDS)
    got = got["hits"]
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    assert np.abs(want[1]["tex_const"]).max() > 0 and np.abs(want[1]["sph_center"]).max() > 0
    _, jax_nonfinite = _hold_grads(want, got, 1e-3, 1e-3)
    assert jax_nonfinite == 0  # the sky catches every path: no lane misses


def test_grad_matches_jax_triangles():
    """Gradients through triangles: the mini cornell_dragon from a camera
    on the knot, 16x16, depth 3; tri_attr (the rows hit_attributes reads),
    pln_corner and tex_const against jax.grad.  Measured: worst error
    1.4e-6 of the field's largest entry.  Required: rtol 1e-3 and atol 1e-3
    of the largest entry per field.

    The room has no sky, so some paths leave it and hit nothing.  JAX's
    gradient of the albedo of material 0 (tex_const row 1) is NaN: a
    missed lane's masked shading is NaN and 0 * NaN reaches it (ROADMAP
    Queue 3).  The port gives that lane a unit normal (integrator.py:
    shade_hits), so its gradients are finite everywhere; they are compared
    where JAX's are finite, and tex_const row 1 is held against a central
    difference of the port's loss instead.  Measured: within 9.0e-7 of it
    (relative).  Required: rel <= 1e-4."""
    scene = mini_dragon_scene(jax_graph())
    sc = jcfg.merge_scene_config(scene.config, {"output_width": 16})
    camera = dict(image_width=16, aspect_ratio=float(sc["aspect_ratio"]), samples_per_pixel=1,
                  max_depth=DEPTH, position=tuple(sc["camera_pos"]), look_at=(267.5, 200.0, 277.5),
                  focal_length=120.0)
    want, got, loss_fn, tp = _grads(scene, ("tri_attr", "pln_corner", "tex_const"),
                                    camera=camera)
    got = got["hits"]
    assert np.abs(want[1]["tri_attr"]).max() > 0
    _, jax_nonfinite = _hold_grads(want, got, 1e-3, 1e-3)
    assert not np.isfinite(want[1]["tex_const"][1]).any()
    assert jax_nonfinite == 3

    # Where JAX gives NaN, hold the port's gradient against a central
    # difference of its own loss.  No decision of the trace depends on an
    # albedo, so the loss is a polynomial of degree <= DEPTH in each entry
    # of tex_const row 1, and Richardson's extrapolation of the steps h and
    # h / 2 removes the whole truncation error: what is left is f32
    # rounding.
    base = tp.tex_const.detach()

    def loss_at(c, delta):
        const = base.clone()
        const[1, c] += delta
        with torch.no_grad():
            return float(loss_fn(tp._replace(tex_const=const)))

    h = 0.1
    for c in range(3):
        d_h = (loss_at(c, h) - loss_at(c, -h)) / (2 * h)
        d_h2 = (loss_at(c, h / 2) - loss_at(c, -h / 2)) / h
        fd = (4 * d_h2 - d_h) / 3
        assert abs(fd) > 0
        assert abs(got[1]["tex_const"][1, c] - fd) <= 1e-4 * abs(fd), (c, got[1]["tex_const"][1, c], fd)


def test_remat_modes_identical():
    """remat "none", "hits" and "full" give the same loss and the same
    gradients bit for bit (with and without compaction)."""
    for compact in (True, False):
        _, got, _, _ = _grads(_probe_scene(jax_graph()), PROBE_FIELDS,
                        remats=("none", "hits", "full"), compact=compact, with_jax=False)
        for remat in ("hits", "full"):
            assert got[remat][0] == got["none"][0]
            for f in PROBE_FIELDS:
                np.testing.assert_array_equal(got[remat][1][f], got["none"][1][f], err_msg=f)


def test_trace_rejects_unknown_remat(mini):
    to, td, tctx = mini["tray"]
    with pytest.raises(ValueError, match="remat"):
        tint.trace(mini["tp"], mini["ts"], to, td, tctx, 1, 0.25, differentiable=True,
                   remat="auto")
