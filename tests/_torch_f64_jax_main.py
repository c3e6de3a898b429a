"""Subprocess body for tests/test_torch_f64.py: the JAX package's f64
validation trace, dumped for the port to be held against.  Runs in its own
process with JAX_ENABLE_X64=1, as tests/_grad_fd_main.py does, so x64 mode
never leaks into the f32 suite.

    python tests/_torch_f64_jax_main.py OUT.npz

Writes to OUT.npz: the f64 ScenePack leaves of _grad_fd_main.py's scene
(`probe/<field>`, tex_data as `probe/tex_data/<i>`), of the mini
cornell_dragon of tests/test_torch_scene.py (`dragon/...`) and of
`empty_pack(float64)` (`empty/...`); the probe scene's
radiance (16x16, 1 spp, depth 3, seed 7, `radiance`); and the analytic
gradients of _grad_fd_main.py's loss with respect to the probed tables
(`grad/<field>`).
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, os.pardir))
sys.path.insert(0, _HERE)

from rust_raytracer_tpu.core import rng as vrng  # noqa: E402
from rust_raytracer_tpu.render import integrator  # noqa: E402
from rust_raytracer_tpu.render.camera import Camera  # noqa: E402
from rust_raytracer_tpu.scene import compiler as sc  # noqa: E402
from rust_raytracer_tpu.scene import graph as g  # noqa: E402
from rust_raytracer_tpu.scene import pack as sp  # noqa: E402

from test_torch_scene import (PROBE_DEPTH as DEPTH, PROBE_LANES as N,  # noqa: E402
                              PROBED, mini_dragon_scene, probe_camera, probe_scene)


def leaves(prefix, pack, out):
    for f in pack.__dataclass_fields__:
        v = getattr(pack, f)
        if f == "tex_data":
            for i, d in enumerate(v):
                out[f"{prefix}/tex_data/{i}"] = np.asarray(d)
        else:
            out[f"{prefix}/{f}"] = np.asarray(v)


def main():
    out = {}
    pack, static = sc.compile_scene(probe_scene(g), dtype=jnp.float64)
    leaves("probe", pack, out)
    dragon, _ = sc.compile_scene(mini_dragon_scene(g), dtype=jnp.float64)
    leaves("dragon", dragon, out)
    leaves("empty", sp.empty_pack(jnp.float64), out)

    cam = probe_camera(Camera)
    w = cam.image_width
    px = jnp.asarray(np.arange(N) % w, jnp.uint32)
    py = jnp.asarray((np.arange(N) // w) % cam.image_height, jnp.uint32)
    sample = jnp.zeros((N,), jnp.uint32)
    seed = jnp.uint32(7)
    wgt = jnp.cos(jnp.arange(N * 3, dtype=jnp.float64)).reshape(N, 3)

    def radiance(pack, differentiable):
        ctx = vrng.Ctx(pixel=py * np.uint32(w) + px, sample=sample,
                       bounce=jnp.uint32(0), seed=seed)
        org, dirn = cam.generate_rays(px, py, sample, ctx, jnp.float64)
        return integrator.trace(pack, static, org, dirn, ctx, DEPTH, 0.25,
                                differentiable=differentiable)

    out["radiance"] = np.asarray(jax.jit(lambda p: radiance(p, False))(pack))
    grad = jax.jit(jax.grad(lambda p: jnp.sum(radiance(p, True) * wgt),
                            allow_int=True))(pack)
    for f in PROBED:
        out[f"grad/{f}"] = np.asarray(getattr(grad, f))
    np.savez(sys.argv[1], **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
