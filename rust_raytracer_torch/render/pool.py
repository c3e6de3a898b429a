"""Persistent ray-pool renderer on one device (port of
rust_raytracer_tpu/render/pool.py).

A fixed-size lane array is kept near full occupancy: every step advances
every lane one bounce; lanes whose path ends add their radiance into the
image accumulator and are refilled with the next un-issued (pixel, sample)
job.  The RNG is keyed by (pixel, sample, bounce) (core/rng.py), so the
schedule changes no sample; only the order of each pixel's sum differs from
the reference (index_add_ on the card sums in no fixed order).

Step order, as the reference: shade the vertex, compaction-sort the lanes
(dead last) BEFORE retiring and refilling, add retirees into the image,
refill dead lanes pixel-major from the job counter.  The step is plain
PyTorch; the triangle traversal inside it is the chosen traversal's CUDA
kernels on the card (`kernel`: the BVH8 walk or the wavefront pipeline,
whose cap-overflow count the state sums on the device).  On the card the
step replays a CUDA graph of its body (render/graphs.py), the reference's
jitted step with its state donated; on the CPU it runs eagerly.

With a `mesh` (parallel/mesh.py) the lane axis is sharded as the
reference's shard_map shards it: the lanes split evenly, and shard s owns a
contiguous slice of the job grid (`_shard_quota`), an accumulator plane and
its job counter, so the state carries the reference's shard axis (`accum`
(n_shards, n_pixels, 3), `next_flat` and `overflow` (n_shards,)) and a
checkpoint of it is interchangeable with the reference's.  Each shard
compaction-sorts only its own lanes.  Without a mesh the state has no shard
axis and the step is the one-device step.

`poll_loop` is the host loop that render_pool and
render/checkpoint.py:render_pool_resumable share.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core import rng as vrng
from ..parallel import mesh as pmesh
from ..utils import metrics as metricsmod
from . import graphs, integrator


class PoolState(NamedTuple):
    org: torch.Tensor         # (L, 3) f32 (f64 in the validation dtype)
    dirn: torch.Tensor        # (L, 3)
    throughput: torch.Tensor  # (L, 3)
    radiance: torch.Tensor    # (L, 3)
    pixel: torch.Tensor       # (L,) int64 holding u32
    sample: torch.Tensor      # (L,) int64
    bounce: torch.Tensor      # (L,) int64
    active: torch.Tensor      # (L,) bool
    accum: torch.Tensor       # (n_pixels, 3) image radiance sums; (S, n_pixels, 3) sharded
    next_flat: torch.Tensor   # () int64 jobs issued so far; (S,) sharded
    overflow: torch.Tensor    # () int64 wavefront cap-overflow packets (0: exact walk); (S,)


def init_state(n_lanes: int, n_pixels: int, device, dtype=torch.float32,
               n_shards: Optional[int] = None) -> PoolState:
    """The empty pool of `n_lanes` lanes; with `n_shards`, the state of
    that many shards (a shard axis on accum, next_flat and overflow)."""
    i64 = torch.int64
    axis = () if n_shards is None else (n_shards,)
    return PoolState(
        org=torch.zeros((n_lanes, 3), dtype=dtype, device=device),
        dirn=torch.ones((n_lanes, 3), dtype=dtype, device=device),
        throughput=torch.zeros((n_lanes, 3), dtype=dtype, device=device),
        radiance=torch.zeros((n_lanes, 3), dtype=dtype, device=device),
        pixel=torch.zeros((n_lanes,), dtype=i64, device=device),
        sample=torch.zeros((n_lanes,), dtype=i64, device=device),
        bounce=torch.zeros((n_lanes,), dtype=i64, device=device),
        active=torch.zeros((n_lanes,), dtype=torch.bool, device=device),
        accum=torch.zeros(axis + (n_pixels, 3), dtype=dtype, device=device),
        next_flat=torch.zeros(axis, dtype=i64, device=device),
        overflow=torch.zeros(axis, dtype=i64, device=device),
    )


def _shard_quota(shard: int, n_shards: int, total: int):
    """Contiguous balanced partition of [0, total): shard s owns
    [start, start + quota) (the reference's _shard_quota)."""
    q, r = divmod(int(total), n_shards)
    return shard * q + min(shard, r), q + int(shard < r)


def make_step(pack, static, camera, total: int, spp: int, seed,
              kernel: str = "auto", mesh: Optional[pmesh.Mesh] = None,
              graph: bool = True):
    """Build the pool step `step(pack, state) -> state`.  `total` =
    n_pixels * spp lane-jobs; flat job ids are pixel-major (pixel =
    flat // spp) so consecutive refills share pixels.  `kernel` is the
    triangle traversal (ops/intersect.py KERNELS).

    On a CUDA device (where graphs.applies) the step is a
    graphs.GraphedStep: captured at its first call, then one graph replay
    a step.  graph=False keeps it eager there too, as on the CPU: the
    reference the graphed step is held against.

    With `mesh`, the step runs this process's shards: the state's lanes
    split evenly over them in order, shard i (global shard mesh.first + i)
    steps its lanes on its device with accum[i], next_flat[i] and
    overflow[i], issuing from its own job-grid slice; each shard's step is
    graphed on its device, and the slicing and joining around them run
    eagerly.  A state without the shard axis is taken as one shard."""
    total = int(total)

    def local(dev, job_base, quota):
        fn = _local_step(static, camera, spp, seed, kernel, job_base, quota)
        return graphs.GraphedStep(fn) if graph and graphs.applies(dev, kernel, pack) else fn

    if mesh is None:
        return local(pack.device, 0, total)
    shards = [(dev, local(dev, *_shard_quota(mesh.first + i, mesh.n_shards, total)))
              for i, dev in enumerate(mesh.devices)]
    replica = pmesh.replicas(pack)

    def step(pack_, s: PoolState) -> PoolState:
        planes = s.accum if s.accum.ndim == 3 else s.accum[None]
        nf = s.next_flat.reshape(-1)
        ov = s.overflow.reshape(-1)
        per = s.org.shape[0] // len(shards)
        home = s.org.device
        outs = []
        for i, (dev, local) in enumerate(shards):
            lanes = {f: getattr(s, f)[i * per:(i + 1) * per].to(dev)
                     for f in PoolState._fields[:8]}
            sub = PoolState(**lanes, accum=planes[i].to(dev), next_flat=nf[i].to(dev),
                            overflow=ov[i].to(dev))
            outs.append(local(replica(dev) if pack_ is pack else pack_.to(dev), sub))
        lanes = {f: torch.cat([getattr(o, f).to(home) for o in outs])
                 for f in PoolState._fields[:8]}
        return PoolState(**lanes, **{f: torch.stack([getattr(o, f).to(home) for o in outs])
                                     for f in PoolState._fields[8:]})

    return step


def _local_step(static, camera, spp: int, seed, kernel: str, job_base: int, quota: int):
    """The step of one shard's lanes (the reference's step_local): it issues
    jobs job_base + [0, quota) of the flat grid, counting them in its
    next_flat (0-d).  The one-device step is job_base 0, quota total."""
    w = camera.image_width
    max_depth = camera.max_depth
    light_bias = camera.light_bias

    def step(pack, s: PoolState) -> PoolState:
        ctx = vrng.Ctx(pixel=s.pixel, sample=s.sample, bounce=s.bounce, seed=seed)
        emission, weight, new_dir, ended, pos, stats = integrator.shade_vertex(
            pack, static, s.org, s.dirn, ctx, light_bias, s.active, kernel=kernel)
        overflow = s.overflow + stats["wf_overflow"]

        act = s.active[:, None]
        radiance = s.radiance + s.throughput * emission * act
        throughput = s.throughput * torch.where(act, weight, 0.0)
        bounce = s.bounce + 1
        still = s.active & ~ended & (bounce < max_depth)
        org = torch.where(still[:, None], pos, s.org)
        dirn = torch.where(still[:, None], new_dir, s.dirn)
        retired = s.active & ~still
        pixel, sample = s.pixel, s.sample

        # ---- compaction sort before retire/refill: dead lanes (this
        # step's retirees included) pack into the tail; the refill then
        # issues its pixel-major camera rays into that tail ----
        key = integrator._compaction_key(org, dirn, still)
        perm = torch.sort(key, stable=True).indices
        org, dirn = org[perm], dirn[perm]
        throughput, radiance = throughput[perm], radiance[perm]
        pixel, sample, bounce = pixel[perm], sample[perm], bounce[perm]
        still, retired = still[perm], retired[perm]

        # ---- retire finished paths: full-width masked add (masked rows
        # add 0, the same sum as the reference's tail window) ----
        accum = s.accum.index_add(
            0, pixel, torch.where(retired[:, None], radiance, 0.0))

        # ---- refill dead lanes with the next un-issued (pixel, sample) of
        # this shard's slice ----
        dead = ~still
        n_dead = dead.sum()
        rank = torch.cumsum(dead.to(torch.int64), 0) - 1
        new_local = s.next_flat + rank
        issue = dead & (new_local < quota)
        new_flat = new_local + job_base if job_base else new_local
        pix = new_flat // spp
        smp = new_flat % spp
        px = pix % w
        py = pix // w
        ctx0 = vrng.Ctx(pixel=pix, sample=smp, bounce=0, seed=seed)
        g_org, g_dir = camera.generate_rays(px, py, smp, ctx0, s.org.dtype)

        iss = issue[:, None]
        org = torch.where(iss, g_org, org)
        dirn = torch.where(iss, g_dir, dirn)
        throughput = torch.where(iss, 1.0, throughput)
        radiance = torch.where(iss | retired[:, None], 0.0, radiance)
        pixel = torch.where(issue, pix, pixel)
        sample = torch.where(issue, smp, sample)
        bounce = torch.where(issue, 0, bounce)
        active = still | issue
        next_flat = torch.clamp(s.next_flat + n_dead, max=quota)

        out = PoolState(org=org, dirn=dirn, throughput=throughput,
                        radiance=radiance, pixel=pixel, sample=sample,
                        bounce=bounce, active=active, accum=accum,
                        next_flat=next_flat, overflow=overflow)
        if metricsmod.nan_checks():
            metricsmod.check_nans("pool step", **{
                f: getattr(out, f) for f in ("org", "dirn", "throughput", "radiance",
                                             "accum")})
        return out

    return step


# Pool steps run between two host reads of the completion counters.
STEPS_PER_POLL = 10


def max_pool_steps(total: int, n_lanes: int, max_depth: int, n_shards: int = 1) -> int:
    """Upper bound on the steps of a render, for safety against scheduling
    bugs: every lane-job takes <= max_depth steps (sharding skew adds a few
    polls, as the reference allows)."""
    return (total * max_depth) // n_lanes + 2 * max_depth * n_shards


def host_sums(mesh: Optional[pmesh.Mesh], *tensors):
    """The sums of `tensors` (e.g. a state's next_flat and active) as host
    ints, all-reduced over the mesh's processes, so every process reads the
    same numbers."""
    sums = [t if t.ndim == 0 else t.sum() for t in tensors]
    if mesh is None or not mesh.multiprocess:
        return tuple(int(x) for x in sums)
    return tuple(int(x) for x in pmesh.all_reduce_sum(mesh, torch.stack(sums)).tolist())


def poll_loop(pack, step, state: PoolState, total: int, max_steps: int,
              steps_per_poll: int = STEPS_PER_POLL, done_steps: int = 0,
              on_poll: Optional[Callable] = None, mesh: Optional[pmesh.Mesh] = None):
    """Run `step` steps_per_poll at a time until every job is issued and no
    lane is active (`host_sums`, one host read a poll), or max_steps.
    `on_poll(state, done_steps, issued, n_active)` is called after each
    poll.  With a mesh across processes the counts are the global ones, so
    every process stops at the same poll.  Returns (state, done_steps)."""
    while done_steps < max_steps:
        for _ in range(steps_per_poll):
            state = step(pack, state)
        done_steps += steps_per_poll
        issued, n_active = host_sums(mesh, state.next_flat, state.active)
        if on_poll is not None:
            on_poll(state, done_steps, issued, n_active)
        if issued >= total and n_active == 0:
            break
    return state, done_steps


def render_pool(pack, static, camera, n_pixels: int, spp: int, n_lanes: int,
                device, seed=0, metrics: Optional[metricsmod.RenderMetrics] = None,
                kernel: str = "auto", dtype=torch.float32,
                mesh: Optional[pmesh.Mesh] = None, step: Optional[Callable] = None):
    """Render n_pixels * spp samples through a pool of n_lanes on `device`.

    Returns the (n_pixels, 3) radiance sum (divide by spp for the mean).
    `metrics`, a utils/metrics.RenderMetrics, records at each poll the
    steps, the live lanes, the jobs issued and the wavefront overflow
    packets out of all 8-lane packets traced, as the reference's pool
    does.  With `mesh`, n_lanes (a multiple of the shard count) is the
    global pool, of which this process holds its shards' share; the result
    is the sum of every shard's plane, the same in every process.  `step`,
    if given, is the make_step of these arguments, built before (a
    Renderer keeps its step, and with it the graphs it captured).
    """
    total = n_pixels * spp
    n_shards = 1 if mesh is None else mesh.n_shards
    if n_lanes % n_shards:
        raise ValueError(f"n_lanes {n_lanes} not divisible by {n_shards} shards")
    local_lanes = n_lanes if mesh is None else n_lanes // n_shards * mesh.n_local
    state = init_state(local_lanes, n_pixels, device, dtype,
                       n_shards=None if mesh is None else mesh.n_local)
    if step is None:
        step = make_step(pack, static, camera, total, spp, seed, kernel=kernel, mesh=mesh)

    def on_poll(state, done_steps, issued, n_active):
        if metrics is not None:
            # poll-granular: one sample covering STEPS_PER_POLL steps at
            # the end-of-poll occupancy
            metrics.record_step(n_active, n_lanes, issued, weight=STEPS_PER_POLL)
            metrics.wf_overflow_packets = host_sums(mesh, state.overflow)[0]
            metrics.wf_total_packets = (n_lanes // 8) * done_steps

    state, _ = poll_loop(pack, step, state, total,
                         max_pool_steps(total, n_lanes, camera.max_depth, n_shards),
                         on_poll=on_poll, mesh=mesh)
    if mesh is None:
        return state.accum
    # the reference's join-and-sum of the per-shard accumulators
    return pmesh.all_reduce_sum(mesh, state.accum.sum(0))
