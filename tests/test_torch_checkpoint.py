"""Checkpoint/resume of the port's pool render (rust_raytracer_torch/render/
checkpoint.py) on the CPU: a render interrupted at an arbitrary step and
resumed from disk gives an image bit-identical to an uninterrupted one (the
JAX package's contract, tests/test_checkpoint.py), a save/load round trip
keeps every field, a checkpoint of other render parameters is refused, and
a file written by the JAX package loads with the JAX state's fields (its
shard axis of 1 dropped, its uint32 ids widened to int64) and resumes in
the port.  Every comparison here is exact."""
import numpy as np
import pytest
import torch

from rust_raytracer_torch import models as tmodels
from rust_raytracer_torch.render import checkpoint as tckpt
from rust_raytracer_torch.render import pool as tpool
from rust_raytracer_torch.render.camera import Camera as TCamera
from rust_raytracer_torch.scene import compiler as tcompiler

torch.set_num_threads(2)

SPP = 4
LANES = 1024
FIELDS = ("org", "dirn", "throughput", "radiance", "pixel", "sample", "bounce", "active",
          "accum", "next_flat", "overflow")
CAM = dict(image_width=32, aspect_ratio=1.0, samples_per_pixel=SPP, max_depth=4,
           position=(0, 0, 1), look_at=(0, 0, 0), focal_length=50.0)
SMOKE_CAM = dict(image_width=24, aspect_ratio=1.0, samples_per_pixel=SPP, max_depth=6,
                 position=(0, 0, 110), look_at=(0, 0, 0), focal_length=35.0)


def _setup(name):
    cam = TCamera(**(SMOKE_CAM if name == "cornell_smoke" else CAM))
    pack, static = tcompiler.compile_scene(tmodels.build(name), "cpu")
    return pack, static, cam, cam.image_width * cam.image_height


def _assert_states_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f


@pytest.mark.parametrize("name", ["test", "cornell_smoke"])
def test_resume_bit_identical(name, tmp_path):
    """Run A: 6 steps, a checkpoint, then a "crash"; resumed with polls of 3
    steps and a checkpoint every 6; the image equals a straight render's
    (polls of 10) bit for bit."""
    pack, static, cam, n_pixels = _setup(name)
    straight = tpool.render_pool(pack, static, cam, n_pixels, SPP, LANES, "cpu", seed=3)

    path = str(tmp_path / "ck.npz")
    state = tpool.init_state(LANES, n_pixels, "cpu")
    step = tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, 3)
    for _ in range(6):
        state = step(pack, state)
    tckpt.save_pool_state(path, state, {"step_count": 6})
    del state

    resumed = tckpt.render_pool_resumable(pack, static, cam, n_pixels, SPP, LANES, "cpu",
                                          seed=3, steps_per_poll=3, checkpoint_path=path,
                                          checkpoint_every_steps=6)
    assert torch.equal(straight, resumed)
    final, meta = tckpt.load_pool_state(path, "cpu")
    assert torch.equal(final.accum, resumed)
    assert int(final.next_flat) == n_pixels * SPP and not final.active.any()
    assert int(meta["params_hash"]) == int(tckpt.params_hash(3, SPP, n_pixels, LANES, cam))


def test_save_load_roundtrip(tmp_path):
    pack, static, cam, n_pixels = _setup("test")
    state = tpool.init_state(LANES, n_pixels, "cpu")
    step = tpool.make_step(pack, static, cam, LANES * 4, SPP, 0)
    for _ in range(2):
        state = step(pack, state)
    path = str(tmp_path / "rt.npz")
    tckpt.save_pool_state(path, state, {"step_count": 2})
    loaded, meta = tckpt.load_pool_state(path, "cpu")
    assert int(meta["step_count"]) == 2
    _assert_states_equal(loaded, state)
    assert int(loaded.next_flat) > 0 and loaded.active.any()


def test_params_hash_mismatch_raises(tmp_path):
    pack, static, cam, n_pixels = _setup("test")
    path = str(tmp_path / "ck.npz")
    state = tpool.init_state(LANES, n_pixels, "cpu")
    tckpt.save_pool_state(path, state, {
        "step_count": 0, "params_hash": tckpt.params_hash(3, SPP, n_pixels, LANES, cam)})
    for seed, spp in ((4, SPP), (3, SPP + 1)):
        with pytest.raises(ValueError, match="different render parameters"):
            tckpt.render_pool_resumable(pack, static, cam, n_pixels, spp, LANES, "cpu",
                                        seed=seed, checkpoint_path=path)
    # the lane count is in the hash; a file without one is checked apart
    tckpt.save_pool_state(path, state, {"step_count": 0})
    with pytest.raises(ValueError, match="lane count"):
        tckpt.render_pool_resumable(pack, static, cam, n_pixels, SPP, LANES // 2, "cpu",
                                    seed=3, checkpoint_path=path)


def test_jax_written_checkpoint_loads(tmp_path):
    """A mid-render file of the JAX package's save_pool_state loads with
    every field equal to the JAX state's; a completed file of its
    render_pool_resumable carries the port's params_hash and resumes in the
    port to the JAX image, bit for bit."""
    from rust_raytracer_tpu import models as jmodels
    from rust_raytracer_tpu.render import checkpoint as jckpt
    from rust_raytracer_tpu.render import pool as jpool
    from rust_raytracer_tpu.render.camera import Camera as JCamera
    from rust_raytracer_tpu.scene import compiler as jcompiler

    jcam = JCamera(**CAM)
    jp, js = jcompiler.compile_scene(jmodels.build("test"))
    n_pixels = jcam.image_width * jcam.image_height
    state = jpool.init_state(LANES, n_pixels)
    step = jpool.make_step(jp, js, jcam, n_pixels * SPP, SPP, 3, kernel="jnp")
    for _ in range(3):
        state = step(jp, state)
    path = str(tmp_path / "jax.npz")
    jckpt.save_pool_state(path, state, {"step_count": 3})
    got, meta = tckpt.load_pool_state(path, "cpu")
    assert int(meta["step_count"]) == 3
    for f in FIELDS:
        want = np.asarray(getattr(state, f))
        if f in ("accum", "next_flat", "overflow"):
            want = want[0]  # the JAX state's shard axis
        t = getattr(got, f)
        assert t.shape == want.shape, f
        assert t.dtype == (torch.int64 if want.dtype.kind in "iu" else
                           torch.from_numpy(want).dtype), f
        np.testing.assert_array_equal(t.numpy(), want, err_msg=f)

    done = str(tmp_path / "jax_done.npz")
    want = np.asarray(jckpt.render_pool_resumable(jp, js, jcam, n_pixels, SPP, LANES, seed=3,
                                                  kernel="jnp", checkpoint_path=done))
    pack, static, cam, _ = _setup("test")
    _, meta = tckpt.load_pool_state(done, "cpu")
    assert np.uint64(meta["params_hash"]) == tckpt.params_hash(3, SPP, n_pixels, LANES, cam)
    got = tckpt.render_pool_resumable(pack, static, cam, n_pixels, SPP, LANES, "cpu", seed=3,
                                      checkpoint_path=done)
    assert got.shape == (n_pixels, 3)
    np.testing.assert_array_equal(got.numpy(), want)
