"""Port camera (rust_raytracer_torch/render/camera.py) against the JAX
camera: host geometry equal, generate_rays org/dirn at rtol 1e-6 and
atol 1e-6 for a pinhole and a depth-of-field camera at spp values that
quantize."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytracer_tpu.core import rng as jrng
from rust_raytracer_tpu.utils import config as cfg
from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.render import camera as tcam

torch.set_num_threads(2)

CASES = {
    # (scene-config overrides, render config): spp 10 -> 9, 2 threads x 20 -> 18
    "pinhole": (dict(output_width=40, aspect_ratio=1.5, focal_length=35.0,
                     camera_pos=(1.0, 2.0, 6.0), camera_target=(0.0, 0.5, 0.0)),
                cfg.RenderConfig(samples_per_pixel=10, max_depth=5)),
    "dof": (dict(output_width=36, aspect_ratio=1.0, focal_length=70.0, f_number=2.8,
                 focus_distance=5.0, camera_pos=(5.0, 2.0, 9.0),
                 camera_target=(0.0, 0.5, 0.0)),
            cfg.RenderConfig(samples_per_pixel=20, thread_count=2, max_depth=5)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_generate_rays_match(name):
    overrides, render = CASES[name]
    sc = cfg.merge_scene_config(overrides)
    jcam = cfg.make_camera(sc, render)
    tcam_ = tcam.camera_from_config(sc, render)
    assert (tcam_.image_height, tcam_.sqrt_spt, tcam_.actual_spp) == (
        jcam.image_height, jcam.sqrt_spt, jcam.actual_spp)
    assert tcam_.actual_spp != render.samples_per_pixel  # spp quantized
    for a in ("first_pixel", "pixel_delta_u", "pixel_delta_v"):
        np.testing.assert_array_equal(getattr(tcam_, a), getattr(jcam, a))
    assert tcam_.aperture_radius == jcam.aperture_radius

    w, h, spp = jcam.image_width, jcam.image_height, jcam.actual_spp
    flat = np.arange(w * h * spp, dtype=np.int64)
    pix, smp = flat // spp, flat % spp
    px, py = pix % w, pix // w
    jctx = jrng.Ctx(jnp.asarray(pix, jnp.uint32), jnp.asarray(smp, jnp.uint32),
                    jnp.uint32(0), jnp.uint32(3))
    jo, jd = jcam.generate_rays(jnp.asarray(px, jnp.uint32), jnp.asarray(py, jnp.uint32),
                                jnp.asarray(smp, jnp.uint32), jctx)
    tctx = trng.Ctx(torch.from_numpy(pix), torch.from_numpy(smp), 0, 3)
    to, td = tcam_.generate_rays(torch.from_numpy(px), torch.from_numpy(py),
                                 torch.from_numpy(smp), tctx)
    assert to.dtype == torch.float32 and to.shape == (w * h * spp, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_make_camera_matches_jax(name):
    """utils/config.make_camera, the reference's name, builds the camera
    the reference's make_camera builds from the same configs."""
    from rust_raytracer_torch.utils import config as tcfg

    overrides, render = CASES[name]
    jcam = cfg.make_camera(cfg.merge_scene_config(overrides), render)
    tcam_ = tcfg.make_camera(tcfg.merge_scene_config(overrides),
                             tcfg.RenderConfig(**vars(render)))
    assert isinstance(tcam_, tcam.Camera)
    for a in ("image_width", "image_height", "aspect_ratio", "focal_length", "f_number",
              "focus_distance", "position", "look_at", "samples_per_pixel", "max_depth",
              "light_bias", "thread_count", "sqrt_spt", "actual_spp", "aperture_radius"):
        assert getattr(tcam_, a) == getattr(jcam, a), a
    for a in ("first_pixel", "pixel_delta_u", "pixel_delta_v"):
        np.testing.assert_array_equal(getattr(tcam_, a), getattr(jcam, a))
