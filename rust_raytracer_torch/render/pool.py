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
whose cap-overflow count the state sums on the device).  Multi-device
sharding (`mesh`) is not ported yet.

`poll_loop` is the host loop that render_pool and
render/checkpoint.py:render_pool_resumable share.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core import rng as vrng
from ..utils import metrics as metricsmod
from . import integrator


class PoolState(NamedTuple):
    org: torch.Tensor         # (L, 3) f32
    dirn: torch.Tensor        # (L, 3) f32
    throughput: torch.Tensor  # (L, 3) f32
    radiance: torch.Tensor    # (L, 3) f32
    pixel: torch.Tensor       # (L,) int64 holding u32
    sample: torch.Tensor      # (L,) int64
    bounce: torch.Tensor      # (L,) int64
    active: torch.Tensor      # (L,) bool
    accum: torch.Tensor       # (n_pixels, 3) f32 image radiance sums
    next_flat: torch.Tensor   # () int64 jobs issued so far
    overflow: torch.Tensor    # () int64 wavefront cap-overflow packets (0: exact walk)


def init_state(n_lanes: int, n_pixels: int, device) -> PoolState:
    f32, i64 = torch.float32, torch.int64
    return PoolState(
        org=torch.zeros((n_lanes, 3), dtype=f32, device=device),
        dirn=torch.ones((n_lanes, 3), dtype=f32, device=device),
        throughput=torch.zeros((n_lanes, 3), dtype=f32, device=device),
        radiance=torch.zeros((n_lanes, 3), dtype=f32, device=device),
        pixel=torch.zeros((n_lanes,), dtype=i64, device=device),
        sample=torch.zeros((n_lanes,), dtype=i64, device=device),
        bounce=torch.zeros((n_lanes,), dtype=i64, device=device),
        active=torch.zeros((n_lanes,), dtype=torch.bool, device=device),
        accum=torch.zeros((n_pixels, 3), dtype=f32, device=device),
        next_flat=torch.zeros((), dtype=i64, device=device),
        overflow=torch.zeros((), dtype=i64, device=device),
    )


def make_step(pack, static, camera, total: int, spp: int, seed,
              kernel: str = "auto"):
    """Build the pool step `step(pack, state) -> state`.  `total` =
    n_pixels * spp lane-jobs; flat job ids are pixel-major (pixel =
    flat // spp) so consecutive refills share pixels.  `kernel` is the
    triangle traversal (ops/intersect.py KERNELS)."""
    w = camera.image_width
    max_depth = camera.max_depth
    light_bias = camera.light_bias
    total = int(total)

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

        # ---- refill dead lanes with the next un-issued (pixel, sample) ----
        dead = ~still
        n_dead = dead.sum()
        rank = torch.cumsum(dead.to(torch.int64), 0) - 1
        new_flat = s.next_flat + rank
        issue = dead & (new_flat < total)
        pix = new_flat // spp
        smp = new_flat % spp
        px = pix % w
        py = pix // w
        ctx0 = vrng.Ctx(pixel=pix, sample=smp, bounce=0, seed=seed)
        g_org, g_dir = camera.generate_rays(px, py, smp, ctx0)

        iss = issue[:, None]
        org = torch.where(iss, g_org, org)
        dirn = torch.where(iss, g_dir, dirn)
        throughput = torch.where(iss, 1.0, throughput)
        radiance = torch.where(iss | retired[:, None], 0.0, radiance)
        pixel = torch.where(issue, pix, pixel)
        sample = torch.where(issue, smp, sample)
        bounce = torch.where(issue, 0, bounce)
        active = still | issue
        next_flat = torch.clamp(s.next_flat + n_dead, max=total)

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


def max_pool_steps(total: int, n_lanes: int, max_depth: int) -> int:
    """Upper bound on the steps of a render, for safety against scheduling
    bugs: every lane-job takes <= max_depth steps."""
    return (total * max_depth) // n_lanes + 2 * max_depth


def poll_loop(pack, step, state: PoolState, total: int, max_steps: int,
              steps_per_poll: int = STEPS_PER_POLL, done_steps: int = 0,
              on_poll: Optional[Callable] = None):
    """Run `step` steps_per_poll at a time until every job is issued and no
    lane is active (two scalars read a poll), or max_steps.  `on_poll(state,
    done_steps, issued, n_active)` is called after each poll.  Returns
    (state, done_steps)."""
    while done_steps < max_steps:
        for _ in range(steps_per_poll):
            state = step(pack, state)
        done_steps += steps_per_poll
        issued = int(state.next_flat)
        n_active = int(state.active.sum())
        if on_poll is not None:
            on_poll(state, done_steps, issued, n_active)
        if issued >= total and n_active == 0:
            break
    return state, done_steps


def render_pool(pack, static, camera, n_pixels: int, spp: int, n_lanes: int,
                device, seed=0, metrics: Optional[metricsmod.RenderMetrics] = None,
                kernel: str = "auto"):
    """Render n_pixels * spp samples through a pool of n_lanes on `device`.

    Returns the (n_pixels, 3) radiance sum (divide by spp for the mean).
    `metrics`, a utils/metrics.RenderMetrics, records at each poll the
    steps, the live lanes, the jobs issued and the wavefront overflow
    packets out of all 8-lane packets traced, as the reference's pool
    does.
    """
    total = n_pixels * spp
    state = init_state(n_lanes, n_pixels, device)
    step = make_step(pack, static, camera, total, spp, seed, kernel=kernel)

    def on_poll(state, done_steps, issued, n_active):
        if metrics is not None:
            # poll-granular: one sample covering STEPS_PER_POLL steps at
            # the end-of-poll occupancy
            metrics.record_step(n_active, n_lanes, issued, weight=STEPS_PER_POLL)
            metrics.wf_overflow_packets = int(state.overflow)
            metrics.wf_total_packets = (n_lanes // 8) * done_steps

    state, _ = poll_loop(pack, step, state, total,
                         max_pool_steps(total, n_lanes, camera.max_depth), on_poll=on_poll)
    return state.accum
