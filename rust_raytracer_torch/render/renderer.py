"""Render orchestration (port of rust_raytracer_tpu/render/renderer.py:
`Renderer.__init__`, `render`, `render_pool`, `render_batched`).

The scene compiles once onto the given device, in the given dtype (f32, or
f64 for the validation trace, which runs the "jnp" walk).
`render(mode="pool")` runs the persistent ray pool (render/pool.py);
`render(mode="batch")` traces the flattened (pixel, sample) grid in
fixed-size batches through `integrator.trace`.  Both return a Film.
Because the RNG is keyed by (pixel, sample, bounce), the two schedules
trace the same paths; they differ only in the order of each pixel's sum.
With a `mesh` (parallel/mesh.py) both schedules shard their lanes over it.
On the card the pool step and the batch bounce replay CUDA graphs
(render/graphs.py); the Renderer keeps the newest of each (graphs.cached),
so a later render replays what an earlier one captured: the batch bounce's
graph at any seed (the seed is a 0-d device tensor in its state), the pool
step's with the same camera, spp, seed, kernel and mesh (the seed is a
constant of the step, as in the reference's jitted pool step).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..core import rng as vrng
from ..ops import intersect as isect
from ..parallel import mesh as pmesh
from ..scene import compiler as scompiler
from ..scene import graph as sgraph
from ..utils import metrics as metricsmod
from . import camera as cam
from . import film as filmmod
from . import graphs
from . import integrator
from . import pool as poolmod

# Default number of lanes in the ray pool, and of lanes per batch.
DEFAULT_BATCH = 1 << 18

MODES = ("pool", "batch")


@dataclasses.dataclass
class BatchMetrics:
    """Counters of one batch render: batches traced and bounces traced in
    all (a batch stops when its last path ends or at max_depth; with a mesh,
    each shard's bounces count)."""
    batches: int = 0
    bounces: int = 0


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
        dtype=torch.float32,
        mesh: Optional[pmesh.Mesh] = None,
        graph: bool = True,
    ):
        """kernel: the triangle traversal (ops/intersect.py KERNELS):
        "auto" — the exact BVH8 walk, or the exact threaded walk where the
        BVH8 kernel cannot run the scene; "bvh8"; "threaded"; "wavefront"
        — the cull -> compact -> MT pipeline (approximate when a packet
        overflows a cap; RenderMetrics.wf_overflow_packets counts them).  CUDA kernels
        for a CUDA device, their plain versions for the CPU.  "jnp" — the
        threaded walk in torch ops, the only walk of dtype=torch.float64
        ("auto" picks it on the CPU; on CUDA any other choice raises
        TypeError).  `mesh` shards both schedules' lanes
        (parallel/mesh.py; the attribute may be set between renders); the
        pack compiles on `device` and is copied to the mesh's other
        devices.  `graph`: on the card, the pool step and the batch bounce
        replay CUDA graphs (render/graphs.py); False runs them eagerly, the
        reference the graphs are held against (the attribute may be set
        between renders).  The CPU and the "jnp" walk always run eagerly."""
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
        self.dtype = dtype
        self.mesh = mesh
        self.graph = graph
        self.pack, self.static = scompiler.compile_scene(scene, self.device, dtype)
        isect.resolve_kernel(kernel, self.pack)
        self._bounces = 0
        self._graphs = {}   # the pool steps and batch bounces built, with their graphs

    def _trace_lanes(self, pack, px, py, sample_id, seed):
        """Radiance (N, 3) of one sample per lane (the reference's batch_fn);
        adds the bounces it traced to self._bounces."""
        camera = self.camera
        ctx = vrng.Ctx(pixel=py * camera.image_width + px, sample=sample_id,
                       bounce=0, seed=seed)
        org, dirn = camera.generate_rays(px, py, sample_id, ctx, self.dtype)
        stats = {}
        rad = integrator.trace(pack, self.static, org, dirn, ctx, camera.max_depth,
                               camera.light_bias, kernel=self.kernel, stats=stats,
                               graph_cache=self._graphs if self.graph else None)
        self._bounces += stats["bounces"]
        return rad

    def render(self, spp: Optional[int] = None, mode: str = "pool",
               metrics: Union[metricsmod.RenderMetrics, BatchMetrics, None] = None
               ) -> filmmod.Film:
        """Render the full image: mode="pool", the persistent ray pool, or
        mode="batch", the bounded-loop schedule.  `metrics`, if given (a
        utils/metrics.RenderMetrics for the pool, a BatchMetrics for the
        batch schedule), records the schedule's counters."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
        if mode == "pool":
            return self.render_pool(spp=spp, metrics=metrics)
        return self.render_batched(spp=spp, metrics=metrics)

    def render_pool(self, spp: Optional[int] = None,
                    metrics: Optional[metricsmod.RenderMetrics] = None) -> filmmod.Film:
        camera = self.camera
        w, h = camera.image_width, camera.image_height
        total_spp = camera.actual_spp if spp is None else spp
        n_pixels = w * h
        n_lanes = min(self.batch_size, n_pixels * total_spp)
        if self.mesh is not None:
            n_shards = self.mesh.n_shards
            n_lanes = max(n_shards, n_lanes - n_lanes % n_shards)

        total = n_pixels * total_spp
        step = graphs.cached(
            self._graphs, (self.pack, self.static, camera, self.mesh),
            ("pool", total, total_spp, self.seed, self.kernel, self.graph),
            lambda: poolmod.make_step(self.pack, self.static, camera, total, total_spp,
                                      self.seed, kernel=self.kernel, mesh=self.mesh,
                                      graph=self.graph))
        accum = poolmod.render_pool(
            self.pack, self.static, camera, n_pixels, total_spp, n_lanes,
            self.device, seed=self.seed, metrics=metrics, kernel=self.kernel,
            dtype=self.dtype, mesh=self.mesh, step=step,
        )
        film = filmmod.Film(w, h)
        film.add_samples(accum.reshape(h, w, 3), total_spp)
        return film

    def trace_batch(self, px, py, sample_id, stats: Optional[dict] = None) -> torch.Tensor:
        """Radiance (N, 3) of one sample per lane: camera rays for pixels
        (px, py) and sample ids, traced to max_depth (int64 tensors on the
        renderer's device), sharded over the mesh if there is one; `stats`,
        a dict if given, gets "bounces": the bounces traced (summed over
        the shards)."""
        self._bounces = 0
        fn = self._trace_lanes
        if self.mesh is not None:
            fn = pmesh.shard_batch_fn(fn, self.mesh)
        rad = fn(self.pack, px, py, sample_id, self.seed)
        if stats is not None:
            stats["bounces"] = self._bounces
        return rad

    def render_batched(self, spp: Optional[int] = None,
                       metrics: Optional[BatchMetrics] = None) -> filmmod.Film:
        """Render the full image: the flattened (pixel, sample) grid,
        pixel-major, is traced in batches of `batch_size` lanes (the tail
        batch padded by wrapping, its padded lanes zeroed), and each batch's
        radiance is summed per pixel on the host in float64, in lane order
        (np.bincount), so the image does not depend on the batch size.  With
        a mesh a batch that the shard count does not divide grows to the
        next multiple of it (the extra lanes are padding)."""
        camera = self.camera
        w, h = camera.image_width, camera.image_height
        total_spp = camera.actual_spp if spp is None else spp
        n_pixels = w * h
        total = n_pixels * total_spp
        batch = min(self.batch_size, total)
        if self.mesh is not None:
            batch = -(-batch // self.mesh.n_shards) * self.mesh.n_shards

        accum = np.zeros((n_pixels, 3), np.float64)
        for start in range(0, total, batch):
            lane = start + np.arange(batch)
            flat = lane % total
            pix = flat // total_spp
            smp = flat % total_spp
            ids = torch.from_numpy(np.stack([pix % w, pix // w, smp])).to(self.device)
            stats = {}
            rad = self.trace_batch(ids[0], ids[1], ids[2], stats).cpu().numpy()
            if metrics is not None:
                metrics.batches += 1
                metrics.bounces += stats["bounces"]
            rad[lane >= total] = 0.0
            for c in range(3):
                accum[:, c] += np.bincount(pix, weights=rad[:, c], minlength=n_pixels)
        film = filmmod.Film(w, h)
        film.add_samples(accum.reshape(h, w, 3), total_spp)
        return film
