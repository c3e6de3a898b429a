"""The port's sharding (rust_raytracer_torch/parallel/mesh.py and the
sharded pool) against itself unsharded and against the JAX package's
8-device mesh (tests/conftest.py's virtual CPU devices): the port analog of
tests/test_sharding.py.

Batch renders are bit-identical at any shard count (the RNG is keyed by
(pixel, sample, bounce), and the image is summed on the host in lane
order).  The sharded pool issues from per-shard job slices into per-shard
planes, as the reference's shard_map: its planes and job counters are held
against the reference's shard for shard, also after a checkpoint the JAX
package wrote is loaded into the port.  train_step_fn sums loss and
gradients over the shards, the reference's psum."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytracer_tpu import models as jmodels
from rust_raytracer_tpu.core import rng as jrng
from rust_raytracer_tpu.parallel import mesh as jmesh
from rust_raytracer_tpu.render import checkpoint as jckpt
from rust_raytracer_tpu.render import integrator as jintegrator
from rust_raytracer_tpu.render import pool as jpool
from rust_raytracer_tpu.render.camera import Camera as JCamera
from rust_raytracer_tpu.scene import compiler as jcompiler
from rust_raytracer_torch import models as tmodels
from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.parallel import mesh as tmesh
from rust_raytracer_torch.render import checkpoint as tckpt
from rust_raytracer_torch.render import integrator as tintegrator
from rust_raytracer_torch.render import pool as tpool
from rust_raytracer_torch.render.camera import Camera as TCamera
from rust_raytracer_torch.render.renderer import Renderer as TRenderer
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

BATCH = 64 * 42 * 4
# the reference's pool test: "test" scene, 32x32, 4 spp, depth 4, 1024 lanes, seed 3
POOL = dict(image_width=32, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
            position=(0, 0, 1), look_at=(0, 0, 0), focal_length=50.0)
LANES, SPP, SEED = 1024, 4, 3
STEPS_BEFORE, STEPS_AFTER = 6, 5


def _render_batched(mesh):
    cam = TCamera(image_width=64, aspect_ratio=1.5, samples_per_pixel=4, max_depth=4,
                  position=(0, 0, 1), look_at=(0, 0, 0), focal_length=50.0)
    return TRenderer(tmodels.build("test"), cam, batch_size=BATCH, device="cpu",
                     mesh=mesh).render_batched().hdr()


@pytest.fixture(scope="module")
def unsharded_image():
    return _render_batched(None)


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_batch_render_shards_bit_identical(unsharded_image, n_shards):
    """Batch renders with 1, 4 and 8 CPU shards equal the unsharded one bit
    for bit (tests/test_sharding.py's contract)."""
    got = _render_batched(tmesh.make_mesh(n_shards, device="cpu"))
    np.testing.assert_array_equal(got, unsharded_image)


def test_pool_8_vs_1_shard():
    """The pool sharded 8 ways reproduces the one-device image within float
    sum order, with equal issued counts (tests/test_sharding.py's
    test_pool_render_1_vs_8_devices)."""
    pack, static = tcompiler.compile_scene(tmodels.build("test"), "cpu")
    cam = TCamera(**POOL)
    n_pixels = cam.image_width * cam.image_height
    imgs, issued = [], []
    for mesh in (None, tmesh.make_mesh(8, device="cpu")):
        m = tmetrics.RenderMetrics()
        imgs.append(tpool.render_pool(pack, static, cam, n_pixels, SPP, LANES, "cpu",
                                      seed=SEED, mesh=mesh, metrics=m).numpy())
        issued.append(m.samples_issued)
    np.testing.assert_allclose(imgs[1], imgs[0], rtol=2e-5, atol=1e-6)
    assert issued[0] == issued[1] == n_pixels * SPP


@pytest.fixture(scope="module")
def jax_pool_8(tmp_path_factory):
    """The JAX package's 8-device pool step (kernel "jnp") from a fresh
    state: STEPS_BEFORE steps, written with its save_pool_state, then
    STEPS_AFTER more.  Returns (state after STEPS_BEFORE as numpy, the
    checkpoint path, state after all steps as numpy)."""
    pack, static = jcompiler.compile_scene(jmodels.build("test"))
    cam = JCamera(**POOL)
    n_pixels = cam.image_width * cam.image_height
    mesh = jmesh.make_mesh(8)
    step = jpool.make_step(pack, static, cam, n_pixels * SPP, SPP, SEED, kernel="jnp",
                           mesh=mesh)
    state = jpool.init_state(LANES, n_pixels, n_shards=8)
    state = jax.device_put(state, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("dp")))
    for _ in range(STEPS_BEFORE):
        state = step(pack, state)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax8.npz")
    jckpt.save_pool_state(path, state)
    before = {f: np.asarray(getattr(state, f)) for f in ("accum", "next_flat", "active")}
    for _ in range(STEPS_AFTER):
        state = step(pack, state)
    after = {f: np.asarray(getattr(state, f)) for f in ("accum", "next_flat", "active")}
    return before, path, after


def _port_step8():
    pack, static = tcompiler.compile_scene(tmodels.build("test"), "cpu")
    cam = TCamera(**POOL)
    n_pixels = cam.image_width * cam.image_height
    step = tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, SEED,
                           mesh=tmesh.make_mesh(8, device="cpu"))
    return pack, step, n_pixels


def _hold_shards(state, want):
    """next_flat per shard equal, each shard's plane within rtol 1e-5."""
    np.testing.assert_array_equal(state.next_flat.numpy(), want["next_flat"].astype(np.int64))
    assert state.accum.shape == want["accum"].shape
    for s in range(want["accum"].shape[0]):
        np.testing.assert_allclose(state.accum[s].numpy(), want["accum"][s], rtol=1e-5,
                                   atol=1e-6, err_msg=f"shard {s}")
    assert int(state.active.sum()) == int(want["active"].sum())


def test_pool_8_shards_against_jax(jax_pool_8):
    """The port's 8-shard pool step against the JAX package's 8-device step
    from the same empty state: each shard issues from its own slice, so
    next_flat per shard is equal exactly and each plane within rtol 1e-5."""
    before, _, _ = jax_pool_8
    pack, step, n_pixels = _port_step8()
    state = tpool.init_state(LANES, n_pixels, "cpu", n_shards=8)
    for _ in range(STEPS_BEFORE):
        state = step(pack, state)
    _hold_shards(state, before)


def test_sharded_checkpoint_from_jax(jax_pool_8, tmp_path):
    """A checkpoint of the JAX package's 8-device pool loads into the port
    with its shard axis, continues under the port's 8-shard step as under
    JAX's, and saves and loads again unchanged."""
    _, path, after = jax_pool_8
    state, _ = tckpt.load_pool_state(path, "cpu")
    assert state.accum.shape[0] == 8 and state.next_flat.shape == (8,)
    pack, step, _ = _port_step8()
    for _ in range(STEPS_AFTER):
        state = step(pack, state)
    _hold_shards(state, after)
    again, _ = tckpt.load_pool_state(tckpt.save_pool_state(str(tmp_path / "p.npz"), state),
                                     "cpu")
    for f in tpool.PoolState._fields:
        assert torch.equal(getattr(again, f), getattr(state, f)), f


# ---------------------------------------------------------------- train step

TRAIN_LANES = 256


def _train_inputs():
    n = TRAIN_LANES
    px = np.arange(n) % 32
    py = (np.arange(n) // 32) % 32
    return px, py


def _port_train(n_shards):
    """Port train_step_fn at n_shards on the reference test's problem:
    "test" scene, 32x32, 1 spp, depth 3, loss mean((rad - 0)^2)."""
    pack, static = tcompiler.compile_scene(tmodels.build("test"), "cpu")
    cam = TCamera(image_width=32, aspect_ratio=1.0, samples_per_pixel=1, max_depth=3,
                  position=(0, 0, 1), look_at=(0, 0, 0), focal_length=50.0)

    def batch_fn(p, px, py, sample, seed):
        ctx = trng.Ctx(pixel=py * 32 + px, sample=sample, bounce=0, seed=seed)
        org, dirn = cam.generate_rays(px, py, sample, ctx)
        return tintegrator.trace(p, static, org, dirn, ctx, 3, 0.25, differentiable=True)

    step = tmesh.train_step_fn(batch_fn, lambda rad, t: ((rad - t) ** 2).mean(),
                               tmesh.make_mesh(n_shards, device="cpu"))
    px, py = (torch.from_numpy(a) for a in _train_inputs())
    loss, grads = step(pack, px, py, torch.zeros_like(px), 0,
                       torch.zeros((TRAIN_LANES, 3)))
    return float(loss), dict(zip(pack.float_fields(), (g.numpy() for g in grads)))


def _jax_train8():
    """JAX's train_step_fn at 8 devices on the same problem, gradients by
    ScenePack field name."""
    pack, static = jcompiler.compile_scene(jmodels.build("test"))
    cam = JCamera(image_width=32, aspect_ratio=1.0, samples_per_pixel=1, max_depth=3,
                  position=(0, 0, 1), look_at=(0, 0, 0), focal_length=50.0)

    def batch_fn(p, px, py, sample, seed):
        ctx = jrng.Ctx(pixel=py * np.uint32(32) + px, sample=sample,
                       bounce=jnp.uint32(0), seed=seed)
        org, dirn = cam.generate_rays(px, py, sample, ctx, jnp.float32)
        return jintegrator.trace(p, static, org, dirn, ctx, 3, 0.25, differentiable=True)

    step = jmesh.train_step_fn(batch_fn, lambda rad, t: jnp.mean((rad - t) ** 2),
                               jmesh.make_mesh(8))
    px, py = (jnp.asarray(a, jnp.uint32) for a in _train_inputs())
    loss, grads = step(pack, px, py, jnp.zeros_like(px), jnp.uint32(0),
                       jnp.zeros((TRAIN_LANES, 3), jnp.float32))
    paths = [jax.tree_util.keystr(k) for k, leaf in jax.tree_util.tree_flatten_with_path(pack)[0]
             if leaf.dtype.kind == "f"]
    names = [p.strip(".") for p in paths]
    return float(loss), {n: np.asarray(g) for n, g in zip(names, grads)}


def test_train_step_shards_and_jax():
    """train_step_fn's loss and gradients at 8 shards equal the 1-shard
    ones times 8 (rtol 1e-6; rtol 1e-5, atol 1e-7, as tests/test_sharding.py)
    and JAX's train_step_fn at 8 devices (loss rtol 1e-5, gradients within
    rtol 1e-3 and 1e-3 of each table's largest entry, test_torch_trace's
    port-against-JAX gradient tolerance)."""
    l1, g1 = _port_train(1)
    l8, g8 = _port_train(8)
    np.testing.assert_allclose(l8 / 8.0, l1, rtol=1e-6)
    assert g1.keys() == g8.keys() and g1
    for f in g1:
        np.testing.assert_allclose(g8[f] / 8.0, g1[f], rtol=1e-5, atol=1e-7, err_msg=f)
    jl, jg = _jax_train8()
    np.testing.assert_allclose(l8, jl, rtol=1e-5)
    assert set(g8) <= set(jg)
    nonzero = 0
    for f, g in g8.items():
        w = jg[f]
        scale = max(float(np.abs(w).max()) if w.size else 0.0, 1e-12)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * scale, err_msg=f)
        nonzero += int(w.size > 0 and np.abs(w).max() > 0)
    assert nonzero >= 3


# ---------------------------------------------------------------- make_mesh

def test_make_mesh_cuda_raises_without_cuda(monkeypatch):
    """A CUDA mesh without CUDA raises; nothing falls back to CPU devices
    (the reference's make_mesh does)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nothing falls back"):
        tmesh.make_mesh(1)
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(2, device="cuda")


def test_make_mesh_cpu_and_repeated_devices():
    """A CPU mesh puts its shards on the one CPU device; an explicit list
    may repeat a device (two shards on one card)."""
    m = tmesh.make_mesh(8, device="cpu")
    assert m.devices == (torch.device("cpu"),) * 8 and m.n_shards == 8 and m.first == 0
    m2 = tmesh.make_mesh(device=["cpu", "cpu"])
    assert m2.n_local == m2.n_shards == 2 and not m2.multiprocess
    with pytest.raises(ValueError):
        tmesh.make_mesh(3, device=["cpu", "cpu"])
