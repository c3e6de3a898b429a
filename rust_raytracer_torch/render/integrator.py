"""The path integrator (port of rust_raytracer_tpu/render/integrator.py):
the compaction key, the path vertex, and `trace`, which follows a batch of
rays to the end of their paths.

The reference's recursive `Camera::ray_color` (camera.rs:282-332) is a loop
over bounce depth on the lane arrays, with the one-sample NEE mixture at
each vertex.  Between bounces `trace` can compact and sort the lanes (dead
last, then direction octant and origin Morton code); the RNG is keyed by
the (pixel, sample, bounce) ids that travel with each lane (core/rng.py),
so reordering changes no sample.

`trace(differentiable=True)` is the reverse-mode form: every bounce runs (no
early exit), the traversal is detached (ops/intersect.py runs it under
torch.no_grad()), and `remat` picks what the backward pass recomputes.  It
makes no host read, so a caller can capture it with its loss and backward
pass as one CUDA graph (render/graphs.py:GraphedGrad, as
parallel/mesh.py:train_step_fn does on the card); called alone it runs
eagerly.  `trace(differentiable=False)` runs its bounces eagerly, with
one host read a bounce: the plain version of the batch render's batch
program (render/renderer.py:BatchProgram), which runs the same bounce
(`bounce_step`) as one CUDA graph on the card, its loop stopping there:
`start_state`, `batch_lanes` and `scatter_back` are the parts it shares
with `trace`.

On the card the non-differentiable vertex (`shade_vertex`, `advance`,
`compaction_key`) runs as the path vertex kernels of ops/vertex.py; the
torch ops here (`shade_hits`, `_advance`, `_compaction_key`) are their
plain versions, which the CPU, the f64 trace and the differentiable
trace run.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils import checkpoint as ckpt

from ..core import math as vmath
from ..core import rng as vrng
from ..ops import gather
from ..ops import intersect as isect
from ..ops import shade as shd
from ..ops import texture as tex
from ..ops import vertex
from ..scene import pack as sp
from ..utils import metrics as metricsmod

REMAT_MODES = ("none", "hits", "full")

# Minimum hit distance (reference: camera.rs:294 Interval(0.001, INF)).
T_MIN = 1e-3


def _expand_bits8(v):
    """Spread the low 8 bits of v to every 3rd bit (Morton interleave)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _compaction_key(org, dirn, alive, dir_bits: int = 3):
    """Sort key (int64 holding the reference's u32): dead lanes last; live
    lanes grouped by direction octant, then 2*dir_bits of finer direction
    quantization, then a Morton code of the origin normalized to this
    wavefront's bounding box.  The dead flag is bit 31, so the key must be
    sorted as int64 (a signed int32 sort would put dead lanes first)."""
    i64 = torch.int64
    dead = (~alive).to(i64)
    octant = ((dirn[:, 0] < 0).to(i64) * 4 + (dirn[:, 1] < 0).to(i64) * 2
              + (dirn[:, 2] < 0).to(i64))
    lo = org.amin(dim=0)
    span = torch.clamp(org.amax(dim=0) - lo, min=1e-20)
    q = torch.clamp((org - lo) / span * 255.0, 0.0, 255.0).to(i64)
    morton = ((_expand_bits8(q[:, 0]) << 2) | (_expand_bits8(q[:, 1]) << 1)
              | _expand_bits8(q[:, 2]))
    key = (dead << 31) | (octant << 28)
    if dir_bits > 0:
        a = torch.abs(dirn)
        a = a / torch.clamp(a[:, 0:1] + a[:, 1:2] + a[:, 2:3], min=1e-20)
        top = (1 << dir_bits) - 1
        qx = torch.clamp((a[:, 0] * top).to(i64), 0, top)
        qy = torch.clamp((a[:, 1] * top).to(i64), 0, top)
        shift = 28 - 2 * dir_bits
        key = key | (qx << (shift + dir_bits)) | (qy << shift)
        key = key | (morton >> (24 - shift))
    else:
        key = key | morton
    return key


def shade_hits(pack, static, org, dirn, hit, ctx, light_bias):
    """The part of a path vertex after the traversal: hit record, texture
    program, NEE-mixture shading, miss -> background.  Differentiable in
    the pack's float tables, `org` and `dirn`; `hit` is detached.

    A lane that hit nothing has a zero normal; its shading is masked (the
    path ends), but the masked branches are NaN there (an orthonormal basis
    about a zero vector), and in the backward pass 0 * NaN would reach the
    gradients of material 0's textures, as it does in the reference
    (ROADMAP Queue 3).  Such a lane gets a unit normal instead, which
    changes no output that a caller reads: the direction of an ended path
    is never traced.

    Returns (emission, weight, new_dir, ended, pos)."""
    attr = isect.hit_attributes(pack, org, dirn, hit)
    unit_z = vmath.const3((0.0, 0.0, 1.0), org.dtype, org.device)
    attr = attr._replace(normal=torch.where(attr.valid[:, None], attr.normal, unit_z))
    tex_values = tex.eval_program(static.tex_program, pack.tex_data, attr.uv,
                                  attr.pos, tex_const=pack.tex_const)
    res = shd.shade(pack, static.light_list, tex_values, org, dirn, hit, attr,
                    ctx, light_bias)
    miss = ~attr.valid
    emission = torch.where(miss[:, None], pack.background[None, :], res.emission)
    ended = res.terminate | miss
    return emission, res.weight, res.new_dir, ended, attr.pos


def shade_vertex(pack, static, org, dirn, ctx, light_bias, alive,
                 kernel: str = "auto", counters=None):
    """One path vertex: closest hit, texture program, NEE-mixture shading,
    miss -> background.

    Returns (emission, weight, new_dir, ended, pos, stats) as the
    reference; stats["wf_overflow"] is the number of packets that
    overflowed a wavefront cap this vertex (a 0-d int64 tensor on the
    device; 0 for the exact walks).  `counters`, the pool step's
    (ops/vertex.py:new_counters), if given, has added to its rows in
    place: in a scene with volumes the vertex's free-flight scattering
    events of the `alive` lanes, in a scene with spheres the `alive` lanes
    whose closest hit is a sphere and the vertex hit kernel's sphere-BVH
    node visits and sphere tests, and the BVH8 kernel's leaf visits and
    groups tested (on the card; the CPU's walks count nothing).  On the
    card (ops/vertex.py:use_kernels) this is KV1, the walk, KV-FF (in a
    scene with volumes) and KV2 (ops/vertex.py:fused_vertex); its plain
    version, which the CPU runs, is `intersect` and `shade_hits`.
    """
    if vertex.use_kernels(pack, org, dirn):
        return vertex.fused_vertex(pack, static, org, dirn, ctx, light_bias, alive, kernel,
                                   T_MIN, counters)
    vertex.plain_calls["vertex_hit"] += 1
    vertex.plain_calls["vertex_shade"] += 1
    if pack.vol_kinds:
        vertex.plain_calls["free_flight"] += 1
    hit, stats = isect.intersect(pack, org, dirn, T_MIN, ctx, alive=alive, kernel=kernel,
                                 return_stats=True)
    if counters is not None:
        for row, kind, present in ((vertex.ROW_VOLUME, sp.PRIM_VOLUME, pack.vol_kinds),
                                   (vertex.ROW_SPHERE, sp.PRIM_SPHERE, pack.sph_center.shape[0])):
            if present:
                on = hit.kind == kind
                counters[row, 0] += (on if alive is None else on & alive).sum()
    return (*shade_hits(pack, static, org, dirn, hit, ctx, light_bias), stats)


class BounceState(NamedTuple):
    """The lanes of a batch between two bounces of `trace`: their state,
    their index in the caller's order (`src`), their RNG keys, the bounce
    about to be traced and the seed (each an int, or a 0-d int64 tensor
    in a graph, so that one graph serves every bounce and seed)."""
    org: torch.Tensor
    dirn: torch.Tensor
    throughput: torch.Tensor
    radiance: torch.Tensor
    alive: torch.Tensor
    src: torch.Tensor
    pixel: torch.Tensor
    sample: torch.Tensor
    depth: object
    seed: object


def compaction_key(org, dirn, alive):
    """`_compaction_key` of the lanes: KV3's box and key kernels on the
    card (ops/vertex.py:compaction_key), the plain version elsewhere."""
    if vertex.use_kernels(None, org, dirn):
        return vertex.compaction_key(org.contiguous(), dirn.contiguous(), alive.contiguous())
    vertex.plain_calls["lane_bbox"] += 1
    vertex.plain_calls["compaction_key"] += 1
    return _compaction_key(org, dirn, alive)


def _sort_lanes(s: BounceState, routed: bool = False) -> BounceState:
    """The lanes in the stable order of `_compaction_key` (dead last); the
    key through `compaction_key` if `routed` (the non-differentiable
    bounce), else the plain version."""
    key = (compaction_key if routed else _compaction_key)(s.org, s.dirn, s.alive)
    perm = torch.sort(key, stable=True).indices
    return BounceState(*(gather.rows(x, perm, "lanes") for x in s[:-2]), depth=s.depth,
                       seed=s.seed)


def _advance(org, dirn, throughput, radiance, alive, emission, weight, next_dir, ended, pos):
    """Advance the lane state after shading (reference integrator.py:
    197-208): add the emission, scale the throughput, end paths, keep dead
    lanes numerically inert."""
    radiance = radiance + throughput * emission * alive[:, None]
    throughput = throughput * torch.where(alive[:, None], weight, 0.0)
    alive = alive & ~ended
    new_org = torch.where(alive[:, None], pos, org)
    new_dir = torch.where(alive[:, None], next_dir, dirn)
    return new_org, new_dir, throughput, radiance, alive


def advance(pack, *lanes):
    """`_advance(*lanes)`: KV3's batch update on the card
    (ops/vertex.py:lane_update), the plain version elsewhere."""
    if vertex.use_kernels(pack, *lanes[:2]):
        return vertex.lane_update(*(x.contiguous() for x in lanes))
    vertex.plain_calls["lane_update"] += 1
    return _advance(*lanes)


def _shade_bounce(pack, static, light_bias, org, dirn, throughput, radiance, alive, hit, ctx):
    """Shade a bounce's hits and advance the lane state (the
    differentiable trace's bounce)."""
    emission, weight, next_dir, ended, pos = shade_hits(pack, static, org, dirn, hit,
                                                        ctx, light_bias)
    return _advance(org, dirn, throughput, radiance, alive, emission, weight, next_dir,
                    ended, pos)


def bounce_step(static, light_bias: float, compact: bool, kernel: str):
    """`step(pack, s: BounceState) -> BounceState`: one bounce of the
    non-differentiable trace (the compaction sort, the closest hit, the
    shading), a pure function of the pack and the lanes (their seed
    included), so that a graph can replay it (renderer.BatchProgram's loop
    body).  On the card its key, vertex and update are the vertex kernels
    (`compaction_key`, `shade_vertex`, `advance`)."""

    def step(pack, s: BounceState) -> BounceState:
        if compact:
            s = _sort_lanes(s, routed=True)
        ctx = vrng.Ctx(pixel=s.pixel, sample=s.sample, bounce=s.depth, seed=s.seed)
        shaded = shade_vertex(pack, static, s.org, s.dirn, ctx, light_bias, s.alive,
                              kernel=kernel)[:5]
        lanes = advance(pack, *s[:5], *shaded)
        return BounceState(*lanes, src=s.src, pixel=s.pixel, sample=s.sample,
                           depth=s.depth + 1, seed=s.seed)

    return step


def trace(pack, static, org, dirn, rng_ctx, max_depth: int, light_bias: float,
          compact: bool = True, differentiable: bool = False,
          kernel: str = "auto", remat: str = "hits", stats: Optional[dict] = None):
    """Trace a batch of rays to the end of their paths; returns the (N, 3)
    radiance in the caller's lane order (reference integrator.py:143-261).

    `rng_ctx` carries the lanes' pixel and sample ids (int tensors holding
    u32) and the seed; its bounce is ignored (each bounce keys its own).
    With compact=True the lanes are sorted before each bounce by a stable
    int64 sort of `_compaction_key`, and the radiance is scattered back to
    the caller's order at the end.

    differentiable=False: a loop that stops when max_depth bounces ran or
    no lane is alive (one host read a bounce), under torch.no_grad(),
    eagerly.
    differentiable=True: all max_depth bounces, differentiable in the
    pack's float tables (ScenePack.with_grad), with no host read: run
    eagerly here, or captured whole with the caller's loss and backward
    pass by graphs.GraphedGrad (the seed a 0-d device tensor); `remat`
    trades backward recompute for saved activations, with the same forward
    values and the same gradients up to the order in which autograd sums a
    table's contributions from different bounces:
      "none" — save every bounce's activations;
      "hits" — the traversal runs outside torch.utils.checkpoint and the
               rest of the bounce inside it, with the hits as inputs: the
               backward pass recomputes the shading, never a traversal;
      "full" — the whole bounce, traversal included, under checkpoint.
    A mode that fails raises; nothing falls back to another.

    `stats`, a dict if given, gets "bounces": the bounces traced (each
    traces the whole batch once).
    """
    if remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {remat!r}; choose from {REMAT_MODES}")
    s = start_state(org, dirn, rng_ctx)
    if differentiable:
        s, bounces = _trace_differentiable(pack, static, s, max_depth, light_bias, compact,
                                           kernel, remat)
    else:
        with torch.no_grad():
            s, bounces = _trace_bounces(pack, static, s, max_depth, light_bias, compact,
                                        kernel)
    if stats is not None:
        stats["bounces"] = bounces
    return scatter_back(s) if compact else s.radiance


def start_state(org, dirn, rng_ctx) -> BounceState:
    """The lanes of a batch before its first bounce: every lane alive, unit
    throughput, no radiance, in the caller's order (bounce 0)."""
    n = org.shape[0]
    dev = org.device
    return BounceState(
        org=org, dirn=dirn,
        throughput=torch.ones((n, 3), dtype=org.dtype, device=dev),
        radiance=torch.zeros((n, 3), dtype=org.dtype, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        src=torch.arange(n, device=dev),
        pixel=vrng.as_u32(rng_ctx.pixel), sample=vrng.as_u32(rng_ctx.sample), depth=0,
        seed=rng_ctx.seed)


def scatter_back(s: BounceState):
    """The lanes' radiance scattered back to the caller's lane order."""
    return torch.zeros_like(s.radiance).index_copy(0, s.src, s.radiance)


def batch_lanes(start, n: int, total: int, spp: int, width: int):
    """(lane, px, py, sample) of `n` lanes of the flattened (pixel, sample)
    grid, pixel-major, from lane `start` (a 0-d int64 tensor: the ids are
    computed on its device, so a graph serves every batch): lane = start +
    i, wrapped at `total` (a lane >= total is padding), pixel = lane % total
    // spp, sample = lane % total % spp, px = pixel % width, py = pixel //
    width; the reference's batch ids (rust_raytracer_tpu/render/
    renderer.py:146-152)."""
    lane = start + torch.arange(n, device=start.device)
    flat = lane % total
    pix = flat // spp
    return lane, pix % width, pix // width, flat % spp


def _check_nans(depth, s: BounceState):
    if metricsmod.nan_checks():
        metricsmod.check_nans(f"trace bounce {depth}", org=s.org, dirn=s.dirn,
                              throughput=s.throughput, radiance=s.radiance)


def _trace_bounces(pack, static, s, max_depth, light_bias, compact, kernel):
    step = bounce_step(static, light_bias, compact, kernel)
    bounces = 0
    for depth in range(max_depth):
        if not bool(s.alive.any()):
            break
        bounces += 1
        s = step(pack, s)
        _check_nans(depth, s)
    return s, bounces


def _trace_differentiable(pack, static, s, max_depth, light_bias, compact, kernel,
                          remat):
    def shade_bounce(*args):
        return _shade_bounce(pack, static, light_bias, *args)

    def whole_bounce(org, dirn, throughput, radiance, alive, ctx):
        hit = isect.intersect(pack, org, dirn, T_MIN, ctx, alive=alive, kernel=kernel)
        return shade_bounce(org, dirn, throughput, radiance, alive, hit, ctx)

    for depth in range(max_depth):
        if compact:
            s = _sort_lanes(s)
        ctx = vrng.Ctx(pixel=s.pixel, sample=s.sample, bounce=depth, seed=s.seed)
        state = tuple(s[:5])
        if remat == "full":
            # the counter-based RNG draws no torch random numbers: nothing
            # to save for the recompute
            out = ckpt.checkpoint(whole_bounce, *state, ctx, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            hit = isect.intersect(pack, s.org, s.dirn, T_MIN, ctx, alive=s.alive, kernel=kernel)
            if remat == "hits":
                out = ckpt.checkpoint(shade_bounce, *state, hit, ctx, use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                out = shade_bounce(*state, hit, ctx)
        s = BounceState(*out, src=s.src, pixel=s.pixel, sample=s.sample, depth=depth + 1,
                        seed=s.seed)
        _check_nans(depth, s)
    return s, max_depth
