"""The graphed gradient step (render/graphs.py:GraphedGrad, the port's
`jax.jit(jax.value_and_grad(loss))`) and the bounded graph cache, on the
CPU.

A CUDA graph cannot be captured here, so these tests hold what decides
whether the graph is right on the card:

- capture safety of the forward AND the backward pass, for each remat
  mode and exact walk: no op that a capturing CUDA stream refuses, outside
  the traversal kernels' wrappers (tests/test_torch_graph.py's check, run
  over `graphs.value_and_grad`);
- the static buffers: GraphedGrad with the capture replaced by a direct
  call of the captured body equals the eager step bit for bit at several
  seeds with one capture, captures again for a new pack or lane count,
  reads tables written in place, and advances the launch counters by a
  step's launches a replay;
- its loss and gradients against jax.value_and_grad on the probe scene of
  tests/_grad_fd_main.py, at tests/test_torch_trace.py's bounds;
- train_step_fn through the graph on a 2-shard CPU mesh against its eager
  path;
- the Renderer's graph cache keeps the newest graph of each kind, and the
  batch program's one graph serves every seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytracer_tpu.core import rng as jrng
from rust_raytracer_tpu.render import camera as jcam
from rust_raytracer_tpu.render import integrator as jint
from rust_raytracer_tpu.scene import compiler as jcompiler
from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.ops import bvh8 as tbvh8
from rust_raytracer_torch.ops import threaded as tthreaded
from rust_raytracer_torch.ops import wavefront as twf
from rust_raytracer_torch.parallel import mesh as tmesh
from rust_raytracer_torch.render import camera as tcam
from rust_raytracer_torch.render import graphs as tgraphs
from rust_raytracer_torch.render import integrator as tint
from rust_raytracer_torch.render.renderer import Renderer as TRenderer
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.scene import graph as tg
from rust_raytracer_torch.utils import metrics as tmetrics

from test_torch_graph import (CaptureCheck, DirectCapture, camera_of, counted, excluded,
                              graphs_on_cpu)  # noqa: F401  (a fixture)
from test_torch_scene import (PROBE_LANES, PROBE_SEED, PROBED, jax_graph, mini_dragon_scene,
                              port_pack_from_jax, port_static, probe_camera, probe_scene)

torch.set_num_threads(2)

LANES, DEPTH = 256, 4
REMATS = ("none", "hits", "full")


@pytest.fixture(scope="module")
def dragon():
    """The mini cornell_dragon compiled on the CPU, its camera at 16 px."""
    scene = mini_dragon_scene(tg)
    pack, static = tcompiler.compile_scene(scene, "cpu")
    return scene, pack, static, camera_of(scene, depth=DEPTH)


def loss_of(static, cam, kernel, remat, depth=DEPTH):
    """bench.py's fwd+bwd loss cut to size, `loss(pack, px, py, sample,
    seed)`: camera rays, the differentiable trace without compaction, and
    mean(rad ** 2)."""
    def loss(pack, px, py, sample, seed):
        ctx = trng.Ctx(pixel=py * cam.image_width + px, sample=sample, bounce=0, seed=seed)
        org, dirn = cam.generate_rays(px, py, sample, ctx)
        rad = tint.trace(pack, static, org, dirn, ctx, depth, cam.light_bias, compact=False,
                         differentiable=True, kernel=kernel, remat=remat)
        return (rad ** 2).mean()
    return loss


def lanes(cam, n=LANES, seed=0):
    """Raster-order pixels at sample 0 (bench.py:62-67) and the seed as a 0-d
    int64 tensor."""
    ar = torch.arange(n)
    return (ar % cam.image_width, (ar // cam.image_width) % cam.image_height,
            torch.zeros_like(ar), torch.tensor(seed))


def assert_steps_equal(got, want, tag):
    assert torch.equal(got[0], want[0]), f"{tag}: loss"
    assert len(got[1]) == len(want[1])
    for k, (g, w) in enumerate(zip(got[1], want[1])):
        assert torch.equal(g, w), f"{tag}: gradient {k}"


# ---------------------------------------------------------------- capture safety

@pytest.mark.parametrize("kernel", ["bvh8", "threaded"])
@pytest.mark.parametrize("remat", REMATS)
def test_grad_step_is_capture_safe(dragon, monkeypatch, kernel, remat):
    """A whole fwd+bwd step (ray generation, the differentiable trace, the
    loss, torch.autograd.grad) issues no op that a CUDA graph capture
    refuses, outside the traversal kernels' wrappers; the backward pass's
    ops (a checkpoint's recompute included) are seen too.  A step before
    it stands for GraphedGrad's warm-up."""
    _, pack, static, cam = dragon
    check = CaptureCheck()
    for module, name in ((tbvh8, "intersect_triangles_bvh8"),
                         (tthreaded, "intersect_triangles_threaded"),
                         (twf, "cull_compact"), (twf, "mt")):
        excluded(monkeypatch, check, module, name)
    seen = []
    real = CaptureCheck.__torch_dispatch__

    def spy(self, func, types_, args=(), kwargs=None):
        seen.append(func.overloadpacket.__name__)
        return real(self, func, types_, args, kwargs)

    monkeypatch.setattr(CaptureCheck, "__torch_dispatch__", spy)
    fn = loss_of(static, cam, kernel, remat)
    tgraphs.value_and_grad(fn, pack.with_grad(), *lanes(cam, seed=1))
    leaves, args = pack.with_grad(), lanes(cam, seed=2)
    with check:
        loss, grads = tgraphs.value_and_grad(fn, leaves, *args)
    assert not check.refused, check.refused
    # the backward pass ran under the check: the gathers' and index ops'
    # backward kernels were seen
    assert {"index_put_", "scatter_add"} & set(seen) or "_index_put_impl_" in seen, set(seen)
    assert float(loss) > 0 and any(bool(g.abs().max() > 0) for g in grads if g.numel())


# ---------------------------------------------------------------- static buffers

@pytest.mark.parametrize("remat", REMATS)
def test_graphed_grad_equals_eager(dragon, monkeypatch, remat):
    """GraphedGrad with the capture a direct call equals the eager step bit
    for bit at seeds 1, 2, 3 and back at 1, with one capture; every
    returned gradient stays valid after later calls; a replay advances the
    K3 counter by a step's launches (DEPTH, twice that under "full", whose
    backward recomputes the walk), the warm-up and the capture by none."""
    _, pack, static, cam = dragon
    counted(monkeypatch, tthreaded, "intersect_triangles_threaded")
    fn = loss_of(static, cam, "threaded", remat)
    capture = DirectCapture()
    step = tgraphs.GraphedGrad(fn, capture=capture)
    seeds = (1, 2, 3, 1)
    wants = [tgraphs.value_and_grad(fn, pack.with_grad(), *lanes(cam, seed=s)) for s in seeds]
    tthreaded.launches = 0
    kept = [step(pack, *lanes(cam, seed=s)) for s in seeds]
    per = DEPTH * (2 if remat == "full" else 1)
    assert tthreaded.launches == len(seeds) * per
    assert capture.count == 1
    assert step.captures[torch.device("cpu")].launched == {"threaded_traverse": per}
    for s, got, want in zip(seeds, kept, wants):
        assert_steps_equal(got, want, f"seed {s}")
    assert not torch.equal(kept[0][0], kept[1][0])   # the seed reaches the graph
    assert all(not g.requires_grad for g in kept[0][1]) and not kept[0][0].requires_grad


def test_graphed_grad_follows_pack_and_lanes(dragon):
    """A new capture for a pack of other tensors and for another lane count,
    none for the same pack rebuilt around the same tensors; a table written
    in place is read by the next replay; release() drops the capture, and
    debug_nans runs the step eagerly without a capture."""
    _, pack, static, cam = dragon
    fn = loss_of(static, cam, "bvh8", "hits", depth=2)
    capture = DirectCapture()
    step = tgraphs.GraphedGrad(fn, capture=capture)
    step(pack, *lanes(cam, seed=1))
    step(pack.to("cpu"), *lanes(cam, seed=2))
    assert capture.count == 1
    other = pack._replace(tex_const=pack.tex_const.clone())
    assert_steps_equal(step(other, *lanes(cam, seed=1)),
                       tgraphs.value_and_grad(fn, other.with_grad(), *lanes(cam, seed=1)),
                       "other pack")
    assert capture.count == 2
    half = lanes(cam, LANES // 2, seed=1)
    assert_steps_equal(step(other, *half), tgraphs.value_and_grad(fn, other.with_grad(), *half),
                       "half the lanes")
    assert capture.count == 3
    assert step.captures[torch.device("cpu")].key[0][0] == (LANES // 2,)
    before = step(other, *half)
    other.tex_const.mul_(0.5)
    after = step(other, *half)
    assert capture.count == 3
    assert_steps_equal(after, tgraphs.value_and_grad(fn, other.with_grad(), *half),
                       "written in place")
    assert not torch.equal(after[0], before[0])
    step.release()
    assert not step.captures
    with tmetrics.debug_nans():
        assert_steps_equal(step(other, *half),
                           tgraphs.value_and_grad(fn, other.with_grad(), *half), "debug_nans")
    assert capture.count == 3 and not step.captures


# ---------------------------------------------------------------- against JAX

@pytest.fixture(scope="module")
def probe():
    """jax.value_and_grad of tests/_grad_fd_main.py's loss (the sum of
    radiance times cos weights over 16x16 pixels, 1 spp, depth 3, seed 7)
    on the JAX-compiled probe scene, run as tests/test_torch_trace.py's
    _grads runs it, with the port's pack and static tables of that
    compile."""
    jp, js = jcompiler.compile_scene(probe_scene(jax_graph()))
    jc = probe_camera(jcam.Camera)
    w = jc.image_width
    px = np.arange(PROBE_LANES) % w
    py = (np.arange(PROBE_LANES) // w) % jc.image_height
    wgt = np.cos(np.arange(PROBE_LANES * 3, dtype=np.float64)).reshape(-1, 3).astype(np.float32)

    def jloss(pack):
        jpx, jpy = jnp.asarray(px, jnp.uint32), jnp.asarray(py, jnp.uint32)
        sample = jnp.zeros((PROBE_LANES,), jnp.uint32)
        ctx = jrng.Ctx(pixel=jpy * np.uint32(w) + jpx, sample=sample, bounce=jnp.uint32(0),
                       seed=jnp.uint32(PROBE_SEED))
        org, dirn = jc.generate_rays(jpx, jpy, sample, ctx, jnp.float32)
        rad = jint.trace(pack, js, org, dirn, ctx, jc.max_depth, 0.25, compact=True,
                         differentiable=True, kernel="jnp")
        return jnp.sum(rad * jnp.asarray(wgt))

    jl, jg = jax.value_and_grad(jloss, allow_int=True)(jp)
    want = (float(jl), {f: np.asarray(getattr(jg, f)) for f in PROBED})
    return want, port_pack_from_jax(jp), port_static(js), (px, py, wgt)


@pytest.mark.parametrize("remat", REMATS)
def test_graphed_grad_matches_jax(probe, remat):
    """The graphed step (the capture a direct call) on the probe scene
    against jax.value_and_grad, at tests/test_torch_trace.py's bounds: loss
    rel <= 1e-5; each field within rtol 1e-3 and atol 1e-3 of its largest
    entry.  Measured as the eager port's (test_grad_matches_jax): loss rel
    8.1e-7, worst gradient 7.4e-7 of the field's largest entry."""
    want, pack, static, (px, py, wgt) = probe
    cam = probe_camera(tcam.Camera)

    def loss(p, px, py, sample, seed, weight):
        ctx = trng.Ctx(pixel=py * cam.image_width + px, sample=sample, bounce=0, seed=seed)
        org, dirn = cam.generate_rays(px, py, sample, ctx)
        rad = tint.trace(p, static, org, dirn, ctx, cam.max_depth, 0.25, compact=True,
                         differentiable=True, kernel="threaded", remat=remat)
        return (rad * weight).sum()

    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    args = (tpx, tpy, torch.zeros_like(tpx), torch.tensor(PROBE_SEED), torch.from_numpy(wgt))
    capture = DirectCapture()
    step = tgraphs.GraphedGrad(loss, capture=capture)
    step(pack, *args)
    got_loss, got = step(pack, *args)
    assert capture.count == 1
    got = dict(zip(pack.float_fields(), got))
    assert abs(float(got_loss) - want[0]) <= 1e-5 * abs(want[0])
    for f, w in want[1].items():
        g = got[f].numpy()
        assert np.isfinite(g).all() and np.isfinite(w).all(), f
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * float(np.abs(w).max()),
                                   err_msg=f)
    assert np.abs(want[1]["tex_const"]).max() > 0 and np.abs(got["sph_center"].numpy()).max() > 0


# ---------------------------------------------------------------- train_step_fn

def test_train_step_fn_graphed_equals_eager(dragon, graphs_on_cpu, monkeypatch):
    """train_step_fn on make_mesh(2, device="cpu") through GraphedGrad (the
    capture a direct call, as on the card) equals its eager path
    (graph=False) bit for bit at seeds 0 and 5; the two shards share one
    capture (one device, one pack, one lane layout), replayed once a shard
    a step (K3 launches = shards x DEPTH a step)."""
    _, pack, static, cam = dragon
    counted(monkeypatch, tthreaded, "intersect_triangles_threaded")
    mesh = tmesh.make_mesh(2, device="cpu")

    def batch_fn(p, px, py, sample, seed):
        ctx = trng.Ctx(pixel=py * cam.image_width + px, sample=sample, bounce=0, seed=seed)
        org, dirn = cam.generate_rays(px, py, sample, ctx)
        return tint.trace(p, static, org, dirn, ctx, DEPTH, cam.light_bias, compact=False,
                          differentiable=True, kernel="threaded")

    def loss(rad, target):
        return ((rad - target) ** 2).mean()

    graphed = tmesh.train_step_fn(batch_fn, loss, mesh, kernel="threaded")
    eager = tmesh.train_step_fn(batch_fn, loss, mesh, kernel="threaded", graph=False)
    px, py, smp, _ = lanes(cam)
    target = torch.full((LANES, 3), 0.25)
    for seed in (0, 5):
        tthreaded.launches = 0
        got = graphed(pack, px, py, smp, seed, target)
        assert tthreaded.launches == 2 * DEPTH
        assert_steps_equal(got, eager(pack, px, py, smp, seed, target), f"seed {seed}")
    assert graphs_on_cpu.count == 1
    assert len(got[1]) == len(pack.float_fields()) and float(got[0]) > 0


# ---------------------------------------------------------------- the graph cache

def test_cached_keeps_the_newest_of_each_kind():
    """graphs.cached builds an entry once per key, and a new key drops the
    older entries of its kind (values[0]) and no other."""
    cache, built = {}, []
    pin = object()

    def make(tag):
        return lambda: built.append(tag) or tag

    assert tgraphs.cached(cache, (pin,), ("pool", 1), make("p1")) == "p1"
    assert tgraphs.cached(cache, (pin,), ("batch", 1), make("b1")) == "b1"
    assert tgraphs.cached(cache, (pin,), ("pool", 1), make("again")) == "p1"
    assert tgraphs.cached(cache, (pin,), ("pool", 2), make("p2")) == "p2"
    assert built == ["p1", "b1", "p2"]
    assert sorted(v for _, v in cache.values()) == ["b1", "p2"]


@pytest.mark.parametrize("mode", ["pool", "batch"])
def test_renderer_cache_is_bounded(dragon, graphs_on_cpu, mode):
    """Renders at seeds 0, 1, 2 keep one graph of their kind in the
    Renderer's cache: the batch program, whose seed is a 0-d tensor, is
    built once for all three (its loop once, no per-bounce capture); the
    pool step, keyed by its seed as the reference's jitted step closes
    over it, is captured once a seed, each replacing the last.  Every
    image equals the eager render's at its seed bit for bit."""
    scene, _, _, cam = dragon
    r = TRenderer(scene, cam, batch_size=LANES, kernel="threaded", device="cpu")
    eager = TRenderer(scene, cam, batch_size=LANES, kernel="threaded", device="cpu",
                      graph=False)
    for seed in (0, 1, 2):
        r.seed = eager.seed = seed
        np.testing.assert_array_equal(r.render(mode=mode).hdr(),
                                      eager.render(mode=mode).hdr())
        assert len(r._graphs) == 1
    assert (graphs_on_cpu.count, graphs_on_cpu.loops) == ((0, 1) if mode == "batch" else (3, 0))
