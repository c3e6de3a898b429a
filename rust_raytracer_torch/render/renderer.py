"""Render orchestration (port of rust_raytracer_tpu/render/renderer.py:
`Renderer.__init__`, `render`, `render_pool`).

The scene compiles once onto the given device; `render(mode="pool")` runs
the persistent ray pool (render/pool.py) and returns a Film.  The batch
schedule (`mode="batch"`) is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from rust_raytracer_tpu.scene import graph as sgraph

from ..ops import intersect as isect
from ..scene import compiler as scompiler
from . import camera as cam
from . import film as filmmod
from . import pool as poolmod

# Default number of lanes in the ray pool.
DEFAULT_BATCH = 1 << 18


class Renderer:
    def __init__(
        self,
        scene: sgraph.SceneDef,
        camera: cam.Camera,
        seed: int = 0,
        batch_size: int = DEFAULT_BATCH,
        kernel: str = "auto",
        *,
        device,
    ):
        """kernel: "auto" or "bvh8" — the exact BVH8 traversal; "wavefront"
        — the cull -> compact -> MT pipeline (approximate when a packet
        overflows a cap; PoolMetrics.overflow counts them).  CUDA kernels
        for a CUDA device, their plain versions for the CPU.  "threaded" is
        not ported yet and raises NotImplementedError."""
        isect.check_kernel(kernel)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; nothing falls back to the CPU")
        self.camera = camera
        self.seed = seed
        self.batch_size = batch_size
        self.kernel = kernel
        self.pack, self.static = scompiler.compile_scene(scene, self.device)
        if self.pack.vol_kind.shape[0]:
            raise NotImplementedError(
                "scenes with volumes are not ported yet (ROADMAP Queue 1, volumes)")

    def render(self, spp: Optional[int] = None, mode: str = "pool",
               metrics: Optional[poolmod.PoolMetrics] = None) -> filmmod.Film:
        """Render the full image with the persistent ray pool."""
        if mode != "pool":
            raise NotImplementedError(
                f"mode={mode!r} is not ported yet (ROADMAP Queue 1, batch mode)")
        return self.render_pool(spp=spp, metrics=metrics)

    def render_pool(self, spp: Optional[int] = None,
                    metrics: Optional[poolmod.PoolMetrics] = None) -> filmmod.Film:
        camera = self.camera
        w, h = camera.image_width, camera.image_height
        total_spp = camera.actual_spp if spp is None else spp
        n_pixels = w * h
        n_lanes = min(self.batch_size, n_pixels * total_spp)

        accum = poolmod.render_pool(
            self.pack, self.static, camera, n_pixels, total_spp, n_lanes,
            self.device, seed=self.seed, metrics=metrics, kernel=self.kernel,
        )
        film = filmmod.Film(w, h)
        film.add_samples(accum.reshape(h, w, 3), total_spp)
        return film
