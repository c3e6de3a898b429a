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
On the card the pool step replays a CUDA graph a step and a batch of the
batch render is one launch of a graph that holds the whole batch program,
its bounce loop included (`BatchProgram`, render/graphs.py:LoopGraph);
`trace_batch`, its plain version, runs eagerly.  The Renderer keeps the
newest graph of each kind (graphs.cached), so a later render replays what
an earlier one captured: the batch program at any seed (the seed is a 0-d
device tensor), the pool step's with the same camera, spp, seed, kernel
and mesh (the seed is a constant of the step, as in the reference's
jitted pool step).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from ..core import rng as vrng
from ..ops import intersect as isect
from ..ops import vertex
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
    each shard's bounces count); and the host's seconds, split into
    launching the batches (graphed: the batch-start fill, the launch and
    the copies home; eager: the whole trace and its read back), waiting on a
    batch's copy home, and the float64 sum per pixel."""
    batches: int = 0
    bounces: int = 0
    launch_s: float = 0.0
    wait_s: float = 0.0
    sum_s: float = 0.0


class BatchProgram:
    """One batch of the batch render on one device as one program: the
    reference's `jax.jit(batch_fn)` (rust_raytracer_tpu/render/renderer.py:
    57-77) with its bounce loop (render/integrator.py:248-256).

    From the 0-d int64 `start` (the batch's first lane) and `seed`, the
    prologue computes this shard's `n` lane ids (integrator.batch_lanes,
    from lane start + `offset`) and camera rays and starts the lanes; the
    body is one bounce (integrator.bounce_step, compaction on) and the
    any-alive flag of the loop's stop test; the epilogue scatters the
    radiance back to lane order, zeroes the padded lanes (lane >= total)
    and writes it into `out`.  `bounces` counts the bodies run.  On the
    card `run()` is one launch of a graphs.LoopGraph (its stop test on the
    card); on the CPU a graphs.PlainLoop runs the same stages.  Every
    tensor the stages read or write is a static buffer made here."""

    def __init__(self, pack, static, camera, n: int, offset: int, total: int, spp: int,
                 kernel: str, dtype=torch.float32):
        dev = pack.device
        i64 = torch.int64
        self.pack, self.camera, self.dtype = pack, camera, dtype
        self.n, self.offset, self.total, self.spp = n, offset, total, spp

        def zeros(shape, dtype_):
            return torch.zeros(shape, dtype=dtype_, device=dev)

        self.start, self.seed = zeros((), i64), zeros((), i64)
        self.state = integrator.BounceState(
            org=zeros((n, 3), dtype), dirn=zeros((n, 3), dtype),
            throughput=zeros((n, 3), dtype), radiance=zeros((n, 3), dtype),
            alive=zeros((n,), torch.bool), src=zeros((n,), i64), pixel=zeros((n,), i64),
            sample=zeros((n,), i64), depth=zeros((), i64), seed=self.seed)
        self.any_alive = torch.ones((), dtype=torch.bool, device=dev)
        self.flag = torch.ones((), dtype=torch.uint8, device=dev)
        self.bounces = zeros((), i64)
        self.out = zeros((n, 3), dtype)
        self._step = integrator.bounce_step(static, camera.light_bias, True, kernel)
        vertex.prepare(pack, static)
        self.loop = graphs.loop_graph(self.prologue, self.body, self.epilogue, self.any_alive,
                                      self.state.depth, self.flag, self.bounces,
                                      camera.max_depth)

    def lanes(self):
        """(lane, px, py, sample) of this shard's lanes of the batch."""
        return integrator.batch_lanes(self.start + self.offset, self.n, self.total, self.spp,
                                      self.camera.image_width)

    def prologue(self) -> None:
        _, px, py, smp = self.lanes()
        ctx = vrng.Ctx(pixel=py * self.camera.image_width + px, sample=smp, bounce=0,
                       seed=self.seed)
        org, dirn = self.camera.generate_rays(px, py, smp, ctx, self.dtype)
        for buf, t in zip(self.state[:-2], integrator.start_state(org, dirn, ctx)[:-2]):
            buf.copy_(t)
        self.state.depth.zero_()
        self.bounces.zero_()

    def body(self) -> None:
        s = self._step(self.pack, self.state)
        for buf, t in zip(self.state[:-1], s[:-1]):
            buf.copy_(t)
        self.any_alive.copy_(s.alive.any())

    def epilogue(self) -> None:
        lane = self.lanes()[0]
        rad = integrator.scatter_back(self.state)
        self.out.copy_(torch.where((lane < self.total)[:, None], rad, 0.0))

    def run(self) -> None:
        """The batch from the current `start` and `seed` into `out`."""
        self.loop.launch()


class BatchRun:
    """The batch programs of a graphed batch render, one a shard of this
    process, and two host buffers (pinned on the card) that the batches'
    radiance and bounce counts are copied into, in turns.  `launch(start,
    slot)` fills each program's `start`, launches it and queues the copies
    home, then records an event; `wait(slot)` waits on that event and
    returns the batch's radiance (this process's lanes) and bounces, and
    advances the launch counters by them."""

    def __init__(self, parts, static, camera, total: int, spp: int, kernel: str, dtype):
        self.programs = [BatchProgram(pack, static, camera, n, offset, total, spp, kernel,
                                      dtype) for pack, offset, n in parts]
        n_local = sum(p.n for p in self.programs)
        pin = self.programs[0].out.device.type == "cuda"
        self.rad = [torch.empty((n_local, 3), dtype=dtype, pin_memory=pin) for _ in range(2)]
        self.bounces = [torch.empty((len(self.programs),), dtype=torch.int64, pin_memory=pin)
                        for _ in range(2)]
        self.events = [[torch.cuda.Event() if pin else None for _ in self.programs]
                       for _ in range(2)]

    def set_seed(self, seed: int) -> None:
        for p in self.programs:
            p.seed.fill_(seed)

    def launch(self, start: int, slot: int) -> None:
        row = 0
        for i, p in enumerate(self.programs):
            p.start.fill_(start)
            p.run()
            self.rad[slot][row:row + p.n].copy_(p.out, non_blocking=True)
            self.bounces[slot][i].copy_(p.bounces, non_blocking=True)
            row += p.n
            if self.events[slot][i] is not None:
                self.events[slot][i].record(torch.cuda.current_stream(p.out.device))

    def wait(self, slot: int):
        for ev in self.events[slot]:
            if ev is not None:
                ev.synchronize()
        counts = self.bounces[slot].tolist()
        for p, b in zip(self.programs, counts):
            p.loop.count(b)
        return self.rad[slot].numpy(), sum(counts)


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
        devices.  `graph`: on the card, the pool step and the batch program
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
        self.renders = 0    # renders started, each span `render`'s unit
        self._graphs = {}   # the pool steps and batch runs built, with their graphs

    def _trace_lanes(self, pack, px, py, sample_id, seed):
        """Radiance (N, 3) of one sample per lane (the reference's batch_fn);
        adds the bounces it traced to self._bounces."""
        camera = self.camera
        ctx = vrng.Ctx(pixel=py * camera.image_width + px, sample=sample_id,
                       bounce=0, seed=seed)
        org, dirn = camera.generate_rays(px, py, sample_id, ctx, self.dtype)
        stats = {}
        rad = integrator.trace(pack, self.static, org, dirn, ctx, camera.max_depth,
                               camera.light_bias, kernel=self.kernel, stats=stats)
        self._bounces += stats["bounces"]
        return rad

    def render(self, spp: Optional[int] = None, mode: str = "pool",
               metrics: Union[metricsmod.RenderMetrics, BatchMetrics, None] = None
               ) -> filmmod.Film:
        """Render the full image: mode="pool", the persistent ray pool, or
        mode="batch", the bounded-loop schedule.  `metrics`, if given (a
        utils/metrics.RenderMetrics for the pool, a BatchMetrics for the
        batch schedule), records the schedule's counters; a RenderMetrics
        also the render's host seconds (`render_s`), up to the image in the
        Film on the host.  The render is span `render` on a profiler's
        trace (utils/metrics.py:span), its index (`renders`) its unit."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
        t0 = time.perf_counter()
        self.renders += 1
        with metricsmod.span("render", self.renders):
            if mode == "pool":
                film = self.render_pool(spp=spp, metrics=metrics)
            else:
                film = self.render_batched(spp=spp, metrics=metrics)
        if isinstance(metrics, metricsmod.RenderMetrics):
            metrics.render_s += time.perf_counter() - t0
        return film

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
        state = poolmod.run_pool(
            self.pack, self.static, camera, n_pixels, total_spp, n_lanes,
            self.device, seed=self.seed, metrics=metrics, kernel=self.kernel,
            dtype=self.dtype, mesh=self.mesh, step=step,
        )
        with metricsmod.span("render.tail"):
            accum = poolmod.pool_image(state, self.mesh, self.device)
            film = filmmod.Film(w, h)
            film.add_samples(accum.reshape(h, w, 3), total_spp)
        return film

    def trace_batch(self, px, py, sample_id, stats: Optional[dict] = None) -> torch.Tensor:
        """Radiance (N, 3) of one sample per lane: camera rays for pixels
        (px, py) and sample ids, traced to max_depth (int64 tensors on the
        renderer's device), sharded over the mesh if there is one, eagerly
        (the batch program's plain version); `stats`,
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

    def _batch_run(self, batch: int, total: int, spp: int) -> BatchRun:
        """The graphed batch render's programs for this batch layout, one a
        shard of this process (the Renderer's cache keeps the newest)."""
        if self.mesh is None:
            parts = [(self.pack, 0, batch)]
        else:
            replica = pmesh.replicas(self.pack)
            parts = [(replica(dev), sl.start, sl.stop - sl.start)
                     for dev, sl in zip(self.mesh.devices, pmesh.lane_slices(self.mesh, batch))]
        return graphs.cached(
            self._graphs, (self.pack, self.static, self.camera, self.mesh),
            ("batch", batch, total, spp, self.kernel),
            lambda: BatchRun(parts, self.static, self.camera, total, spp, self.kernel,
                             self.dtype))

    def render_batched(self, spp: Optional[int] = None,
                       metrics: Optional[BatchMetrics] = None) -> filmmod.Film:
        """Render the full image: the flattened (pixel, sample) grid,
        pixel-major, is traced in batches of `batch_size` lanes (the tail
        batch padded by wrapping, its padded lanes zeroed), and each batch's
        radiance is summed per pixel on the host in float64, in lane order
        (np.bincount), so the image does not depend on the batch size or
        the shard count.  With a mesh a batch that the shard count does not
        divide grows to the next multiple of it (the extra lanes are
        padding).

        On the card (where graphs.applies, with graph on and outside
        metrics.debug_nans) a batch is one launch of each shard's
        BatchProgram, and the host sums batch i while the card traces batch
        i + 1: its one wait a batch is on the previous batch's copy home.
        Otherwise each batch runs `trace_batch` eagerly (ids made on the
        device, the bounce loop read on the host each bounce) and is summed
        before the next.  Both add the same float32 radiance in the same
        order, so their images are equal bit for bit."""
        camera = self.camera
        w, h = camera.image_width, camera.image_height
        total_spp = camera.actual_spp if spp is None else spp
        n_pixels = w * h
        total = n_pixels * total_spp
        batch = min(self.batch_size, total)
        if self.mesh is not None:
            batch = -(-batch // self.mesh.n_shards) * self.mesh.n_shards
        metrics = BatchMetrics() if metrics is None else metrics
        accum = np.zeros((n_pixels, 3), np.float64)

        def add(start, rad, bounces):
            t0 = time.perf_counter()
            metrics.batches += 1
            metrics.bounces += bounces
            pix = (start + np.arange(batch)) % total // total_spp
            for c in range(3):
                accum[:, c] += np.bincount(pix, weights=rad[:, c], minlength=n_pixels)
            metrics.sum_s += time.perf_counter() - t0

        graphed = (self.graph and graphs.applies(self.device, self.kernel, self.pack)
                   and not metricsmod.nan_checks())
        if graphed:
            run = self._batch_run(batch, total, total_spp)
            run.set_seed(self.seed)
            starts = list(range(0, total, batch))
            for k, start in enumerate(starts + [None]):
                t0 = time.perf_counter()
                if start is not None:
                    run.launch(start, k % 2)
                t1 = time.perf_counter()
                if k:
                    rad, bounces = run.wait((k - 1) % 2)
                    if self.mesh is not None and self.mesh.multiprocess:
                        rad = pmesh.all_gather_cat(self.mesh, torch.from_numpy(rad)).numpy()
                    metrics.wait_s += time.perf_counter() - t1
                    add(starts[k - 1], rad, bounces)
                metrics.launch_s += t1 - t0
        else:
            for start in range(0, total, batch):
                t0 = time.perf_counter()
                first = torch.full((), start, dtype=torch.int64, device=self.device)
                _, px, py, smp = integrator.batch_lanes(first, batch, total, total_spp, w)
                stats = {}
                rad = self.trace_batch(px, py, smp, stats).cpu().numpy()
                rad[start + np.arange(batch) >= total] = 0.0
                metrics.launch_s += time.perf_counter() - t0
                add(start, rad, stats["bounces"])
        film = filmmod.Film(w, h)
        film.add_samples(accum.reshape(h, w, 3), total_spp)
        return film
