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
refill dead lanes pixel-major from the job counter.  On the card the step
is the path vertex kernels of ops/vertex.py around the chosen traversal's
CUDA kernels (`kernel`: the BVH8 walk or the wavefront pipeline, whose
cap-overflow count the state sums on the device), with the sort and the
image's index_add between them; its plain version, which the CPU runs,
is torch ops (integrator.shade_vertex, `update_plain`, `refill_plain`).
On the card the step replays a CUDA graph of its body (render/graphs.py),
the reference's jitted step with its state donated; on the CPU it runs
eagerly.

With a `mesh` (parallel/mesh.py) the lane axis is sharded as the
reference's shard_map shards it: the lanes split evenly, and shard s owns a
contiguous slice of the job grid (`_shard_quota`), an accumulator plane and
its job counter.  The state is a `ShardedState`, one PoolState a shard of
this process made on that shard's device (`init_shards`), the port's
NamedSharding-placed state: each step advances every shard's state on its
own device, and no lane, plane or counter moves between polls.  The joins
are the reference's: a poll reads each device's counts (`shard_sums`), the
image is the planes' sum in shard order (`sum_planes`), and a checkpoint
or a check reads the stacked layout (`join_field`: the reference's shard
axis, `accum` (n_shards, n_pixels, 3), `next_flat` and `overflow`
(n_shards,)), so a checkpoint is interchangeable with the reference's.
Each shard compaction-sorts only its own lanes.  Without a mesh the pool
is the one-shard case of the same code, its state one PoolState with no
shard axis (the reference's one-device layout).

`init_pool` and `poll_loop` are the set-up and the host loop that run_pool
and render/checkpoint.py:render_pool_resumable share.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core import rng as vrng
from ..ops import vertex
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


# PoolState's fields with one row a lane; the rest have one a shard
LANE_FIELDS = PoolState._fields[:8]


class ShardedState(tuple):
    """The pool state of this process's shards: one PoolState a shard, on
    that shard's device, with its n_lanes / n_shards lanes, its plane
    `accum` (n_pixels, 3) and its 0-d `next_flat` and `overflow`.  A field
    read by name (`state.accum`) is the stacked layout, joined by
    `join_field`: for checks and checkpoints, never inside a step."""
    __slots__ = ()

    def __getattr__(self, name):
        if name not in PoolState._fields:
            raise AttributeError(name)
        return join_field(self, name)


def join_field(state: ShardedState, name: str, device=None) -> torch.Tensor:
    """Field `name` of the shards in the stacked layout, on `device` (the
    first shard's by default): a lane field concatenated in shard order,
    accum, next_flat and overflow stacked on a shard axis."""
    device = state[0].org.device if device is None else device
    parts = [getattr(s, name).to(device) for s in state]
    return torch.cat(parts) if name in LANE_FIELDS else torch.stack(parts)


def place_state(state: PoolState, mesh: pmesh.Mesh) -> ShardedState:
    """A stacked state of this process's shards (init_state with n_shards,
    a loaded checkpoint; a state without the shard axis is one shard) split
    into a ShardedState, each shard's part copied to its device: the
    reference's device_put of the state, done once."""
    planes = state.accum if state.accum.ndim == 3 else state.accum[None]
    if planes.shape[0] != mesh.n_local:
        raise ValueError(f"a state of {planes.shape[0]} shard(s) on a mesh of "
                         f"{mesh.n_local} local shard(s)")
    nf, ov = state.next_flat.reshape(-1), state.overflow.reshape(-1)
    per = state.org.shape[0] // mesh.n_local
    return ShardedState(
        PoolState(*(getattr(state, f)[i * per:(i + 1) * per].to(dev, copy=True)
                    for f in LANE_FIELDS),
                  accum=planes[i].to(dev, copy=True), next_flat=nf[i].to(dev, copy=True),
                  overflow=ov[i].to(dev, copy=True))
        for i, dev in enumerate(mesh.devices))


def init_shards(n_lanes: int, n_pixels: int, mesh: pmesh.Mesh,
                dtype=torch.float32) -> ShardedState:
    """The empty pool of `n_lanes` lanes over all of `mesh`'s shards: this
    process's shards' states, each made on its device."""
    per = n_lanes // mesh.n_shards
    return ShardedState(init_state(per, n_pixels, dev, dtype) for dev in mesh.devices)


def init_pool(n_lanes: int, n_pixels: int, device, dtype=torch.float32,
              mesh: Optional[pmesh.Mesh] = None):
    """The empty pool of a render (span `pool.init`): `init_state` on
    `device`, or with `mesh` `init_shards` (n_lanes a multiple of its
    shard count)."""
    n_shards = 1 if mesh is None else mesh.n_shards
    if n_lanes % n_shards:
        raise ValueError(f"n_lanes {n_lanes} not divisible by {n_shards} shards")
    with metricsmod.span("pool.init"):
        if mesh is None:
            return init_state(n_lanes, n_pixels, device, dtype)
        return init_shards(n_lanes, n_pixels, mesh, dtype)


def shards(state) -> tuple:
    """A ShardedState's shards; a PoolState is one shard."""
    return state if isinstance(state, ShardedState) else (state,)


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

    The step runs one local step a shard (`step.shard_steps`), each
    issuing from its own slice of the job grid.  Without a mesh the one
    shard is the whole grid on the pack's device and the step maps a
    PoolState to the next one; with `mesh`, shard i (global shard
    mesh.first + i) steps its own state on its device and the step maps a
    ShardedState of this process's shards to the next one, joining and
    copying nothing.  A stacked state (init_state with n_shards, a loaded
    checkpoint) is placed once (`place_state`) at the step that receives
    it.

    On a CUDA device (where graphs.applies) each local step is a
    graphs.GraphedStep: one graph replay a step, which reads and writes its
    state's buffers in place (the state a step returned is overwritten by
    its next call: a chain needs a step of its own).  The shards' replays
    are issued with no host wait between them.  graph=False keeps the steps
    eager there too, as on the CPU: the reference the graphed step is held
    against.

    `step.counters` holds each shard's counters (vertex.new_counters, on
    its device), which the step owns (a graph's static buffer) and adds to
    with no launch of its own (the kernels' atomics, one a warp): in a
    scene with volumes the scattering events of its live lanes, in a scene
    with spheres its live lanes whose closest hit is a sphere, and on the
    card the BVH8 walk's leaf visits and groups tested.  `run_pool`
    zeroes them at a render's start and reads them at its end."""
    total = int(total)
    if mesh is None:
        parts = [(pack.device, 0, total)]
    else:
        parts = [(dev, *_shard_quota(mesh.first + i, mesh.n_shards, total))
                 for i, dev in enumerate(mesh.devices)]
    replica = pmesh.replicas(pack)
    local_steps, counters = [], []
    for dev, job_base, quota in parts:
        vertex.prepare(replica(dev), static, camera)
        fn = _local_step(static, camera, spp, seed, kernel, job_base, quota, dev)
        counters.append(fn.counters)
        if graph and graphs.applies(dev, kernel, pack):
            fn = graphs.GraphedStep(fn, counters=(fn.counters,))
        local_steps.append(fn)

    if mesh is None:
        # a closure, not the local step itself: `step.shard_steps` then
        # holds no cycle that would keep a dropped step's graph alive
        def step(pack_, s: PoolState) -> PoolState:
            return local_steps[0](pack_, s)
    else:
        def step(pack_, s: ShardedState) -> ShardedState:
            if not isinstance(s, ShardedState):
                s = place_state(s, mesh)
            return ShardedState(local(replica(dev) if pack_ is pack else pack_.to(dev), part)
                                for (dev, _, _), local, part in zip(parts, local_steps, s,
                                                                    strict=True))

    step.shard_steps = tuple(local_steps)
    step.counters = tuple(counters)
    return step


def _local_step(static, camera, spp: int, seed, kernel: str, job_base: int, quota: int,
                device=None):
    """The step of one shard's lanes (the reference's step_local): it issues
    jobs job_base + [0, quota) of the flat grid, counting them in its
    next_flat (0-d).  The one-device step is job_base 0, quota total.  It
    adds to `step.counters` (vertex.new_counters on `device`, torch's
    default device if None) as integrator.shade_vertex says."""
    w = camera.image_width
    max_depth = camera.max_depth
    light_bias = camera.light_bias
    counters = vertex.new_counters(device)

    def step(pack, s: PoolState) -> PoolState:
        ctx = vrng.Ctx(pixel=s.pixel, sample=s.sample, bounce=s.bounce, seed=seed)
        emission, weight, new_dir, ended, pos, stats = integrator.shade_vertex(
            pack, static, s.org, s.dirn, ctx, light_bias, s.active, kernel=kernel,
            counters=counters)
        if vertex.use_kernels(pack, s.org, s.dirn):
            out = kernel_tail(s, emission, weight, new_dir, ended, pos, stats["wf_overflow"])
        else:
            out = plain_tail(s, emission, weight, new_dir, ended, pos, stats["wf_overflow"])
        if metricsmod.nan_checks():
            metricsmod.check_nans("pool step", **{
                f: getattr(out, f) for f in ("org", "dirn", "throughput", "radiance",
                                             "accum")})
        return out

    def kernel_tail(s, emission, weight, new_dir, ended, pos, wf_overflow):
        """The step after shading on the card: KV3 (update, key), the sort,
        KV4 (gather, retire, refill), the image's index_add."""
        org, dirn, throughput, radiance, bounce, still, retired, n_dead = (
            vertex.lane_update(s.org, s.dirn, s.throughput, s.radiance, s.active, emission,
                               weight, new_dir, ended, pos, bounce=s.bounce,
                               max_depth=max_depth))
        perm = torch.sort(vertex.compaction_key(org, dirn, still), stable=True).indices
        (org, dirn, throughput, radiance, pixel, sample, bounce, active, ret_pixel, contrib,
         next_flat, overflow) = vertex.pool_refill(
            perm, (org, dirn, throughput, radiance, s.pixel, s.sample, bounce, still, retired),
            n_dead, s.next_flat, s.overflow, wf_overflow,
            vertex.camera_table(camera, s.org.device), quota, job_base, spp, w,
            camera.sqrt_spt, camera.aperture_radius is not None, seed)
        return PoolState(org=org, dirn=dirn, throughput=throughput, radiance=radiance,
                         pixel=pixel, sample=sample, bounce=bounce, active=active,
                         accum=s.accum.index_add(0, ret_pixel, contrib),
                         next_flat=next_flat, overflow=overflow)

    def plain_tail(s, emission, weight, new_dir, ended, pos, wf_overflow):
        """The step after shading in torch ops: the plain versions of KV3
        and KV4 (with the sort between them)."""
        for name in ("lane_update", "lane_bbox", "compaction_key", "pool_refill"):
            vertex.plain_calls[name] += 1
        lanes = update_plain(s, emission, weight, new_dir, ended, pos, max_depth)
        perm = torch.sort(integrator._compaction_key(lanes[0], lanes[1], lanes[7]),
                          stable=True).indices
        return refill_plain(s, perm, lanes, wf_overflow, camera, quota, job_base, spp, seed)

    step.counters = counters
    return step


def update_plain(s: PoolState, emission, weight, new_dir, ended, pos, max_depth: int):
    """The pool's lane update after shading in torch ops, the plain version
    of KV3's update (ops/vertex.py:lane_update): (org, dirn, throughput,
    radiance, pixel, sample, bounce, still, retired) of the lanes, in their
    order."""
    act = s.active[:, None]
    radiance = s.radiance + s.throughput * emission * act
    throughput = s.throughput * torch.where(act, weight, 0.0)
    bounce = s.bounce + 1
    still = s.active & ~ended & (bounce < max_depth)
    org = torch.where(still[:, None], pos, s.org)
    dirn = torch.where(still[:, None], new_dir, s.dirn)
    retired = s.active & ~still
    return org, dirn, throughput, radiance, s.pixel, s.sample, bounce, still, retired


def refill_plain(s: PoolState, perm, lanes, wf_overflow, camera, quota: int, job_base: int,
                 spp: int, seed) -> PoolState:
    """The pool step from its compaction sort's permutation `perm` of
    update_plain's `lanes` on, in torch ops: the plain version of KV4
    (ops/vertex.py:pool_refill) with the image's index_add."""
    w = camera.image_width
    # ---- compaction sort before retire/refill: dead lanes (this step's
    # retirees included) pack into the tail; the refill then issues its
    # pixel-major camera rays into that tail ----
    org, dirn, throughput, radiance, pixel, sample, bounce, still, retired = (
        x[perm] for x in lanes)
    overflow = s.overflow + wf_overflow

    # ---- retire finished paths: full-width masked add (masked rows add 0,
    # the same sum as the reference's tail window) ----
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

    return PoolState(org=org, dirn=dirn, throughput=throughput,
                     radiance=radiance, pixel=pixel, sample=sample,
                     bounce=bounce, active=active, accum=accum,
                     next_flat=next_flat, overflow=overflow)


# Pool steps run between two host reads of the completion counters.
STEPS_PER_POLL = 10


def max_pool_steps(total: int, n_lanes: int, max_depth: int, n_shards: int = 1) -> int:
    """Upper bound on the steps of a render, for safety against scheduling
    bugs: every lane-job takes <= max_depth steps (sharding skew adds a few
    polls, as the reference allows)."""
    return (total * max_depth) // n_lanes + 2 * max_depth * n_shards


def _process_sums(mesh: Optional[pmesh.Mesh], sums) -> tuple:
    """Host ints `sums` summed over the mesh's processes (as they are
    without a mesh or in one process), so every process reads the same."""
    if mesh is None or not mesh.multiprocess:
        return tuple(sums)
    return tuple(int(x) for x in pmesh.all_reduce_sum(mesh, torch.tensor(sums)).tolist())


def host_sums(mesh: Optional[pmesh.Mesh], *tensors):
    """The sums of `tensors` as host ints, all-reduced over the mesh's
    processes.  Nothing calls it; perfbench/core/spans.py wraps it by name."""
    return _process_sums(mesh, [int(t.sum()) for t in tensors])


def shard_sums(mesh: Optional[pmesh.Mesh], state, fields) -> tuple:
    """The sums of the named `fields` over the shards of `state` (a
    ShardedState, or a PoolState as one shard), as host ints: one small
    read a device (the shards of a device summed there first), all-reduced
    over the mesh's processes."""
    by_dev = {}
    for s in shards(state):
        v = torch.stack([getattr(s, f).sum() for f in fields])
        dev = s.org.device
        by_dev[dev] = v if dev not in by_dev else by_dev[dev] + v
    cols = zip(*(v.tolist() for v in by_dev.values()))
    return _process_sums(mesh, [sum(col) for col in cols])


def counter_sums(mesh: Optional[pmesh.Mesh], counters) -> dict:
    """vertex.counter_values of make_step's `counters`, summed over this
    process's shards and the mesh's processes: one small read a shard."""
    values = vertex.counter_values(counters)
    return dict(zip(values, _process_sums(mesh, list(values.values()))))


def sum_planes(mesh: pmesh.Mesh, state: ShardedState, device) -> torch.Tensor:
    """The image of a sharded render: the shards' planes copied to `device`
    and added there in shard order (the same image from run to run), then
    all-reduced over the mesh's processes (the reference's join-and-sum)."""
    with metricsmod.span("mesh.join"):
        image = state[0].accum.to(device, copy=True)
        for s in state[1:]:
            image += s.accum.to(device)
        return pmesh.all_reduce_sum(mesh, image)


# what a poll reads, in one read a device
POLL_FIELDS = ("next_flat", "active", "overflow")


def poll_loop(pack, step, state, total: int, max_steps: int,
              steps_per_poll: int = STEPS_PER_POLL, done_steps: int = 0,
              on_poll: Optional[Callable] = None, mesh: Optional[pmesh.Mesh] = None):
    """Run `step` steps_per_poll at a time until every job is issued and no
    lane is active, or max_steps: a poll reads POLL_FIELDS in one host read
    a device (`shard_sums`).  `on_poll(state, done_steps, issued, n_active,
    overflow)` is called after each poll (`overflow`: the wavefront
    overflow packets so far).  With a mesh across processes the counts are
    the global ones, so every process stops at the same poll.  Returns (state,
    done_steps).  The loop is span `pool.loop`, each poll's read and
    on_poll span `pool.poll` (utils/metrics.py:span)."""
    with metricsmod.span("pool.loop"):
        while done_steps < max_steps:
            for _ in range(steps_per_poll):
                state = step(pack, state)
            done_steps += steps_per_poll
            with metricsmod.span("pool.poll"):
                issued, n_active, overflow = shard_sums(mesh, state, POLL_FIELDS)
                if on_poll is not None:
                    on_poll(state, done_steps, issued, n_active, overflow)
            if issued >= total and n_active == 0:
                break
    return state, done_steps


def render_pool(pack, static, camera, n_pixels: int, spp: int, n_lanes: int,
                device, seed=0, metrics: Optional[metricsmod.RenderMetrics] = None,
                kernel: str = "auto", dtype=torch.float32,
                mesh: Optional[pmesh.Mesh] = None, step: Optional[Callable] = None):
    """Render n_pixels * spp samples through a pool of n_lanes on `device`:
    `run_pool`'s state joined into the image by `pool_image`.  Returns the
    (n_pixels, 3) radiance sum (divide by spp for the mean); with `mesh`,
    the sum of every shard's plane on `device`, the same in every process."""
    state = run_pool(pack, static, camera, n_pixels, spp, n_lanes, device, seed=seed,
                     metrics=metrics, kernel=kernel, dtype=dtype, mesh=mesh, step=step)
    return pool_image(state, mesh, device)


def pool_image(state, mesh: Optional[pmesh.Mesh], device) -> torch.Tensor:
    """The (n_pixels, 3) radiance sum of a finished pool's state on
    `device`: its accum, or with a mesh the shards' planes summed
    (`sum_planes`)."""
    return state.accum if mesh is None else sum_planes(mesh, state, device)


def run_pool(pack, static, camera, n_pixels: int, spp: int, n_lanes: int,
             device, seed=0, metrics: Optional[metricsmod.RenderMetrics] = None,
             kernel: str = "auto", dtype=torch.float32,
             mesh: Optional[pmesh.Mesh] = None, step: Optional[Callable] = None):
    """Run n_pixels * spp samples through a pool of n_lanes on `device`
    until every job is done; returns the final state (`init_pool`, then
    `poll_loop`).

    `metrics`, a utils/metrics.RenderMetrics, records at each poll the
    steps, the live lanes, the jobs issued and the wavefront overflow
    packets out of all 8-lane packets traced, as the reference's pool
    does, in a scene with volumes the render's free-flight scattering
    events (`volume_hits`), in a scene with spheres the lane bounces whose
    closest hit is a sphere (`sphere_hits`) and the vertex hit kernel's
    sphere-BVH node visits and sphere tests (`kv1_node_visits`,
    `kv1_sphere_tests`), and the BVH8 kernel's leaf visits and groups
    tested (`k1_leaf_visits`, `k1_groups_tested`): the step's counters,
    zeroed here and read once the loop has ended.  With `mesh`, n_lanes
    (a multiple of the shard count) is the global pool, of which this
    process holds its shards' share, each shard's state on its device
    (`init_pool`), and the state returned is a ShardedState.  `step`, if given, is the make_step of
    these arguments, built before (a Renderer keeps its step, and with it
    the graphs it captured)."""
    total = n_pixels * spp
    n_shards = 1 if mesh is None else mesh.n_shards
    state = init_pool(n_lanes, n_pixels, device, dtype, mesh)
    if step is None:
        step = make_step(pack, static, camera, total, spp, seed, kernel=kernel, mesh=mesh)
    counters = getattr(step, "counters", ()) if metrics is not None else ()
    for c in counters:
        c.zero_()

    def on_poll(state, done_steps, issued, n_active, overflow):
        if metrics is not None:
            # poll-granular: one sample covering STEPS_PER_POLL steps at
            # the end-of-poll occupancy
            metrics.record_step(n_active, n_lanes, issued, weight=STEPS_PER_POLL)
            metrics.wf_overflow_packets = overflow
            metrics.wf_total_packets = (n_lanes // 8) * done_steps

    state, _ = poll_loop(pack, step, state, total,
                         max_pool_steps(total, n_lanes, camera.max_depth, n_shards),
                         on_poll=on_poll, mesh=mesh)
    if counters:
        sums = counter_sums(mesh, counters)
        if not pack.sph_center.shape[0]:
            for name in ("sphere_hits", "kv1_node_visits", "kv1_sphere_tests"):
                del sums[name]
        for name, value in sums.items():
            setattr(metrics, name, value)
    return state
