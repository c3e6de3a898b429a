"""Ray-scene intersection (port of rust_raytracer_tpu/ops/intersect.py).

Spheres and planes are tested one primitive at a time over all rays with a
running closest hit; triangles go through the chosen traversal, the BVH8
walk (ops/bvh8.py), the threaded-BVH walk (ops/threaded.py) or the
wavefront pipeline (ops/wavefront.py): CUDA kernels on the card, their
plain versions on the CPU; sun and sky are analytic and evaluated after
surfaces.  Hits carry (t, kind, prim); `hit_attributes` gathers the winning
primitive and computes the hit record.  The traversal is not
differentiable: `intersect` runs it under torch.no_grad() (the reference's
stop_gradient on the hits), and `hit_attributes` recomputes t from the
gathered primitive, so gradients flow through that recomputation.

Volumes (constant-density media in a convex boundary) come after the
surfaces: each samples a free-flight distance from the RNG context and is
truncated by the nearest surface.  Each volume's boundary kind is read from
the host (`ScenePack.vol_kinds`), so only that kind's span is computed and
a scene without volumes adds no operation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as vmath
from ..core import rng as vrng
from ..scene import pack as sp
from . import bvh8
from . import gather
from . import threaded
from . import wavefront

# t used for sun hits: beats the sky (inf), loses to any finite surface.
T_SUN = 3.0e38
DET_EPS = 1e-12
SUN_THETA_MAX = 1e-3  # reference: sun.rs:14

# Triangle traversal choices, checked once by Renderer: "bvh8" is the exact
# BVH8 walk, "threaded" the exact threaded-BVH walk, "wavefront" the cull ->
# compact -> MT pipeline (approximate when a packet overflows a cap; the
# overflow is counted).  "auto" is the BVH8 walk where it can run the scene
# and the threaded walk where it cannot (bvh8.fits: no BVH8, or a BVH8 too
# deep for the kernel's stack) — decided from the pack, before any launch.
# "jnp", the reference's name for its portable walk, is the threaded-BVH
# walk in torch ops on any device, in the pack's dtype: the only walk of an
# f64 pack (the CUDA kernels are f32), which "auto" picks on the CPU.
KERNELS = ("auto", "bvh8", "threaded", "wavefront", "jnp")


def check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; choose from {KERNELS}")


def resolve_kernel(kernel: str, pack) -> str:
    """The walk `kernel` names for this pack: an f64 pack takes only "jnp";
    "auto" resolves to it on the CPU, and on CUDA any other choice raises
    TypeError (the card never picks the plain walk unasked).  An f32 pack's
    choice is returned as given."""
    check_kernel(kernel)
    if pack.dtype == torch.float32 or kernel == "jnp":
        return kernel
    if kernel == "auto" and pack.device.type == "cpu":
        return "jnp"
    raise TypeError(
        f"kernel={kernel!r} with a {pack.dtype} pack on {pack.device}: the CUDA "
        "traversal kernels are float32; an f64 pack traces with kernel='jnp'")


class Hit(NamedTuple):
    t: torch.Tensor       # (N,) hit distance (units of |dir|); inf = miss
    kind: torch.Tensor    # (N,) int32 PRIM_* id
    prim: torch.Tensor    # (N,) int32 index into the kind's table


class HitAttributes(NamedTuple):
    pos: torch.Tensor         # (N, 3)
    normal: torch.Tensor      # (N, 3) shading normal, flipped toward the ray
    tangent: torch.Tensor     # (N, 3)
    bitangent: torch.Tensor   # (N, 3)
    uv: torch.Tensor          # (N, 2)
    front_face: torch.Tensor  # (N,) bool
    mat: torch.Tensor         # (N,) int32 material id
    valid: torch.Tensor       # (N,) bool — there was a hit


def _full(n, value, dtype, device):
    return torch.full((n,), value, dtype=dtype, device=device)


def _clip(idx, size):
    """Index into a table of `size` rows.  Lanes of another primitive kind
    carry ids of other tables; clamping keeps their (discarded) gathers in
    bounds."""
    return torch.clamp(idx, max=size - 1)


def sphere_hit_t(org, dirn, center, radius, t_min, t_max):
    """Quadratic ray-sphere test, nearest root in (t_min, t_max)
    (reference: sphere.rs:40-63)."""
    oc = org - center
    a = vmath.length_squared(dirn)
    half_b = vmath.dot(dirn, oc)
    c = vmath.length_squared(oc) - radius * radius
    disc = half_b * half_b - a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.where(disc > 0.0, disc, torch.ones_like(disc)))
    sq = torch.where(ok, sq, torch.zeros_like(sq))
    root1 = (-half_b - sq) / a
    root2 = (-half_b + sq) / a
    v1 = ok & (root1 > t_min) & (root1 < t_max)
    v2 = ok & (root2 > t_min) & (root2 < t_max)
    inf = torch.full_like(root1, float("inf"))
    return torch.where(v1, root1, torch.where(v2, root2, inf))


def intersect_spheres(pack, org, dirn, t_min, t_max):
    """Closest sphere hit, one sphere at a time (the reference's unrolled
    form; its chunked form for > 16 spheres keeps the same winner)."""
    n = org.shape[0]
    best_t = t_max
    best_i = _full(n, -1, torch.int32, org.device)
    affine = pack.sph_inv.shape[0] > 0
    a_plain = vmath.length_squared(dirn)
    for si in range(pack.sph_center.shape[0]):
        if affine:
            inv = pack.sph_inv[si]
            oc = (org - pack.sph_center[si]) @ inv.T
            dl = dirn @ inv.T
            a = vmath.length_squared(dl)
            half_b = vmath.dot(dl, oc)
            c = vmath.length_squared(oc) - 1.0
        else:
            oc = org - pack.sph_center[si]
            a = a_plain
            half_b = vmath.dot(dirn, oc)
            c = vmath.length_squared(oc) - pack.sph_radius[si] ** 2
        disc = half_b * half_b - a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        root1 = (-half_b - sq) / a
        root2 = (-half_b + sq) / a
        ok = disc >= 0.0
        v1 = ok & (root1 > t_min) & (root1 < best_t)
        v2 = ok & (root2 > t_min) & (root2 < best_t)
        inf = torch.full_like(root1, float("inf"))
        t = torch.where(v1, root1, torch.where(v2, root2, inf))
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, si, best_i)
    return best_t, best_i


def plane_hit(org, dirn, corner, dual_u, dual_v, normal, backface, t_min, t_max):
    """Finite-parallelogram test (reference: plane.rs:66-101).  Returns
    (t, u, v) with t = inf on a miss."""
    dot_rn = vmath.dot(normal.expand_as(dirn), dirn)
    dd = torch.where(backface, torch.abs(dot_rn), -dot_rn)
    facing = dd > DET_EPS
    denom = torch.where(torch.abs(dot_rn) > DET_EPS, dot_rn, torch.ones_like(dot_rn))
    t = vmath.dot(normal.expand_as(org), corner - org) / denom
    in_t = facing & (t > t_min) & (t < t_max)
    t_uvsafe = torch.where(in_t, t, torch.ones_like(t))
    pos = org + dirn * t_uvsafe[..., None]
    local = pos - corner
    u = vmath.dot(local, dual_u.expand_as(local))
    v = vmath.dot(local, dual_v.expand_as(local))
    in_uv = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    hit = in_t & in_uv
    return torch.where(hit, t, torch.full_like(t, float("inf"))), u, v


def intersect_planes(pack, org, dirn, t_min, t_max):
    n = org.shape[0]
    best_t = t_max
    best_i = _full(n, -1, torch.int32, org.device)
    for pi in range(pack.pln_corner.shape[0]):
        t, _, _ = plane_hit(
            org, dirn, pack.pln_corner[pi], pack.pln_dual_u[pi],
            pack.pln_dual_v[pi], pack.pln_normal[pi], pack.pln_backface[pi],
            t_min, best_t,
        )
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, pi, best_i)
    return best_t, best_i


def intersect_triangles(pack, org, dirn, t_min, t_max, kernel: str = "auto",
                        return_stats: bool = False, k1_counts=None):
    """Closest triangle hit: (t, slot) with t == t_max where nothing was
    hit (see ops/threaded.py for the contract), through the traversal
    `kernel` names (see KERNELS).  `k1_counts`, a (2,) int64 counter, has
    the BVH8 kernel's leaf visits and groups tested added to it where that
    kernel runs (ops/bvh8.py).  With return_stats=True the
    return is (t, slot, stats), stats["wf_overflow"] the number of packets
    that overflowed a wavefront cap (a 0-d int64 tensor; 0 for the exact
    walk).  The reference's VMEM-fit check for the wavefront pipeline
    (_wavefront_vmem_ok) has no counterpart: the card holds the tables in
    device memory."""
    n = org.shape[0]
    ov = torch.zeros((), dtype=torch.int64, device=org.device)
    kernel = resolve_kernel(kernel, pack)
    if pack.tri_v0.shape[0] == 0 or pack.bvh_min.shape[0] == 0:
        t, i = t_max, _full(n, -1, torch.int32, org.device)
    elif kernel == "jnp":
        t, i = intersect_triangles_jnp(pack, org, dirn, t_min, t_max)
    elif kernel == "wavefront":
        if pack.wf_cl_lo.shape[0] == 0:
            raise ValueError(
                "kernel='wavefront' requested but the scene has no wavefront "
                "cluster tables; use kernel='auto'")
        t, i, ov = wavefront.intersect_triangles_wavefront(
            pack, org, dirn, t_min, t_max, return_overflow=True)
    elif kernel == "threaded" or (kernel == "auto" and not bvh8.fits(pack)):
        t, i = threaded.intersect_triangles_threaded(pack, org, dirn, t_min, t_max)
    else:
        t, i = bvh8.intersect_triangles_bvh8(pack, org, dirn, t_min, t_max, counts=k1_counts)
    if return_stats:
        return t, i, {"wf_overflow": ov}
    return t, i


def intersect_triangles_jnp(pack, org, dirn, t_min, t_max):
    """The reference's portable walk (kernel="jnp", ops/intersect.py:430-497
    with triangle_hit at :268): the threaded BVH in torch ops, reading
    `bvh_min`/`bvh_max` and `tri_v0`/`tri_e1`/`tri_e2`/`tri_hit_back` in the
    pack's dtype, with the caller's `t_min`.  It is threaded.traverse_plain
    on those rows: within a leaf the lowest slot wins at equal t, as the
    reference's sequential `t < best`.  Returns (t, slot) with t == t_max on
    a miss, the convention hit_attributes reads."""
    rows = torch.cat([pack.tri_v0, pack.tri_e1, pack.tri_e2,
                      pack.tri_hit_back.to(pack.tri_v0.dtype)[:, None]], dim=1)
    return threaded.traverse_plain(pack, org, dirn, t_max, rows=rows, t_min=float(t_min))


# ---------------------------------------------------------------------------
# Volumes (reference: object/volume.rs)
# ---------------------------------------------------------------------------

# Elements (lanes x triangles) of one chunk of a mesh boundary's span: each
# (lanes, chunk, 3) f32 temporary stays near 24 MB, whatever the boundary's
# triangle count.
VOL_CHUNK_ELEMS = 1 << 21


def _mesh_crossings(pack, vi, org, dirn, lo, hi):
    """t of every crossing of triangles [lo, hi) of volume vi's padded
    boundary block, inf where the ray misses (padded rows have det 0)."""
    v0 = pack.vol_tri_v0[vi, lo:hi][None]
    e1 = pack.vol_tri_e1[vi, lo:hi][None]
    e2 = pack.vol_tri_e2[vi, lo:hi][None]
    d = dirn[:, None, :]
    pvec = vmath.cross(d, e2)
    det = vmath.dot(e1, pvec)
    inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    bvec = org[:, None, :] - v0
    u = vmath.dot(bvec, pvec) * inv_det
    qvec = vmath.cross(bvec, e1)
    w = vmath.dot(d, qvec) * inv_det
    tt = vmath.dot(e2, qvec) * inv_det
    ok = (torch.abs(det) > DET_EPS) & (u >= 0.0) & (u <= 1.0)
    ok &= (w >= 0.0) & (u + w <= 1.0)
    return torch.where(ok, tt, float("inf"))


def _volume_boundary_span(pack, org, dirn, vi):
    """Entry/exit t of each ray against the convex boundary of volume vi,
    the reference's `_volume_boundary_span` (intersect.py:505-570) for the
    one kind the volume has -> (t_enter, t_exit, valid).

    Sphere/ellipsoid: the unit-sphere quadratic after `vol_axes` (the
    world -> unit-sphere map).  Oriented box: the slab test in the frame of
    `vol_axes` (rotation rows), with NaN-propagating min/max as jnp's.
    Convex mesh: entry is the nearest crossing, exit the nearest crossing
    beyond entry + 1e-6; both are running minima over chunks of
    VOL_CHUNK_ELEMS // lanes triangles, so no (lanes, TB) temporary is
    made whole (two passes when the block takes more than one chunk).  The
    block's padding rows past the volume's own triangles
    (`ScenePack.vol_tri_counts`) are skipped: they are never crossed."""
    kind = pack.vol_kinds[vi]
    if kind == sp.VOL_MESH:
        tb = pack.vol_tri_counts[vi]
        step = max(1, VOL_CHUNK_ELEMS // max(org.shape[0], 1))
        # one chunk: its crossings serve both passes; more: each pass makes them
        whole = [_mesh_crossings(pack, vi, org, dirn, 0, tb)] if tb <= step else None

        def chunks():
            return whole or (_mesh_crossings(pack, vi, org, dirn, lo, lo + step)
                             for lo in range(0, tb, step))

        inf = float("inf")
        enter = torch.stack([ts.amin(dim=1) for ts in chunks()]).amin(dim=0)
        floor = (enter + 1e-6)[:, None]
        exit_ = torch.stack([torch.where(ts > floor, ts, inf).amin(dim=1)
                             for ts in chunks()]).amin(dim=0)
        valid = torch.isfinite(enter) & torch.isfinite(exit_)
        return torch.where(valid, enter, 0.0), torch.where(valid, exit_, 0.0), valid

    axes = pack.vol_axes[vi]
    oc = (org - pack.vol_center[vi]) @ axes.T
    dl = dirn @ axes.T
    if kind == sp.VOL_SPHERE:
        a = vmath.length_squared(dl)
        half_b = vmath.dot(dl, oc)
        c = vmath.length_squared(oc) - 1.0
        disc = half_b * half_b - a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        a_safe = torch.where(a == 0.0, torch.ones_like(a), a)
        return (-half_b - sq) / a_safe, (-half_b + sq) / a_safe, disc > 0.0
    half = pack.vol_halfsize[vi]
    inv = 1.0 / dl
    t0 = (-half - oc) * inv
    t1 = (half - oc) * inv
    enter = torch.minimum(t0, t1).amax(dim=-1)
    exit_ = torch.maximum(t0, t1).amin(dim=-1)
    return enter, exit_, enter < exit_


def intersect_volumes(pack, org, dirn, t_min, t_max, rng_ctx):
    """Stochastic constant-density media (reference: volume.rs:33-71,
    intersect.py:573-601) -> (t, volume id or -1).

    `t_max` is the nearest surface's t, so each free flight is truncated
    there.  Volume vi draws its free-flight distance from stream
    Streams.VOLUME + 16 * vi; a later volume's hit replaces an earlier
    one's, as the reference's unrolled loop."""
    n_v = len(pack.vol_kinds)
    best_i = _full(org.shape[0], -1, torch.int32, org.device)
    if n_v == 0:
        return t_max, best_i
    ray_len = vmath.length(dirn)
    best_t = t_max
    for vi in range(n_v):
        t_enter, t_exit, valid = _volume_boundary_span(pack, org, dirn, vi)
        lo = torch.clamp(torch.maximum(t_enter, t_min), min=0.0)
        hi = torch.minimum(t_exit, best_t)
        inside = valid & (lo < hi)
        dist_inside = (hi - lo) * ray_len
        u = rng_ctx.uniform(vrng.Streams.VOLUME + 16 * vi)
        hit_dist = pack.vol_neg_inv_density[vi] * torch.log(torch.clamp(u, min=1e-30))
        t = lo + hit_dist / ray_len
        hit = inside & (hit_dist <= dist_inside)
        best_i = torch.where(hit, vi, best_i)
        best_t = torch.where(hit, t, best_t)
    return best_t, best_i


def intersect(pack, org, dirn, t_min, rng_ctx, alive=None, kernel: str = "auto",
              return_stats: bool = False):
    """Closest hit across all primitive classes -> Hit, or (Hit, stats)
    with return_stats=True (stats as intersect_triangles returns them).

    Ordering follows the reference's list scan with shrinking intervals:
    finite surface hits first, then the volumes' free-flight samples
    truncated by the nearest surface (`rng_ctx`, a core/rng.Ctx of the
    lanes, keys their draws), then the sun (t = T_SUN) within its cone,
    then the last sky catches everything still unbounded.  `alive` bounds
    the triangle traversal's t_max at 0 for dead lanes, so they exit the
    BVH at the root; their results are garbage by contract.  The whole
    search runs under torch.no_grad(): the hits carry no gradient.
    """
    with torch.no_grad():
        return _intersect(pack, org.detach(), dirn.detach(), t_min, rng_ctx, alive,
                          kernel, return_stats)


def _intersect(pack, org, dirn, t_min, rng_ctx, alive, kernel, return_stats):
    n = org.shape[0]
    dev, dtype = org.device, org.dtype
    inf = _full(n, float("inf"), dtype, dev)
    t_min_lanes = torch.full((n,), t_min, dtype=dtype, device=dev)

    t_sph, i_sph, t_pln, i_pln, tri_tmax = analytic_hits(pack, org, dirn, t_min_lanes, alive,
                                                         inf)
    t_tri, i_tri, stats = intersect_triangles(pack, org.contiguous(), dirn.contiguous(),
                                              t_min, tri_tmax, kernel=kernel,
                                              return_stats=True)
    hit = close_hits(pack, org, dirn, t_min_lanes, rng_ctx, t_sph, i_sph, t_pln, i_pln, t_tri,
                     i_tri, inf)
    if return_stats:
        return hit, stats
    return hit


def analytic_hits(pack, org, dirn, t_min, alive=None, inf=None):
    """`intersect` before the triangle walk: the closest sphere and plane
    hits (t, id) and the walk's t_max (the nearer of the two, 0 on a dead
    lane when `alive` is given), `t_min` the (n,) lanes of T_MIN: the plain
    version of the vertex hit kernel (ops/vertex.py)."""
    if inf is None:
        inf = _full(org.shape[0], float("inf"), org.dtype, org.device)
    t_sph, i_sph = intersect_spheres(pack, org, dirn, t_min, inf)
    t_pln, i_pln = intersect_planes(pack, org, dirn, t_min, inf)
    tri_tmax = torch.minimum(t_sph, t_pln)
    if alive is not None:
        tri_tmax = torch.where(alive, tri_tmax, torch.zeros_like(tri_tmax))
    return t_sph, i_sph, t_pln, i_pln, tri_tmax


def close_hits(pack, org, dirn, t_min, rng_ctx, t_sph, i_sph, t_pln, i_pln, t_tri, i_tri,
               inf=None) -> Hit:
    """`intersect` after the triangle walk: `merge_volumes`, then the sun
    within its cone, then the last sky catches everything still unbounded.
    The plain version of that part of the shading kernel (ops/vertex.py)."""
    t_best, kind, prim = merge_volumes(pack, org, dirn, t_min, rng_ctx, t_sph, i_sph,
                                       t_pln, i_pln, t_tri, i_tri, inf)

    n_sun = pack.sun_dir.shape[0]
    if n_sun:
        unit_d = vmath.normalize(dirn)
        miss = ~torch.isfinite(t_best)
        for ui in range(n_sun):
            cos = vmath.dot(unit_d, pack.sun_dir[ui].expand_as(unit_d))
            take = miss & (torch.abs(cos - 1.0) <= SUN_THETA_MAX)
            t_best = torch.where(take, T_SUN, t_best)
            kind = torch.where(take, sp.PRIM_SUN, kind).to(torch.int32)
            prim = torch.where(take, ui, prim).to(torch.int32)
            miss = miss & ~take

    n_sky = pack.sky_tex.shape[0]
    if n_sky:
        # the LAST sky wins ties (sky.rs:31, list.rs:66-71)
        miss = ~torch.isfinite(t_best)
        kind = torch.where(miss, sp.PRIM_SKY, kind).to(torch.int32)
        prim = torch.where(miss, n_sky - 1, prim).to(torch.int32)
        t_best = torch.where(miss, float("inf"), t_best)
    return Hit(t=t_best, kind=kind, prim=prim)


def merge_volumes(pack, org, dirn, t_min, rng_ctx, t_sph, i_sph, t_pln, i_pln, t_tri, i_tri,
                  inf=None):
    """The closest of the sphere, plane and triangle hits, then the
    volumes' free-flight samples (the part of `intersect` between the walk
    and the sun) -> (t, kind, prim).  `t_min` is a float or the (n,) lanes
    of it.  On the card the shading kernel (ops/vertex.py) runs this merge
    itself in a scene without volumes; with volumes the free-flight kernel
    (ops/vertex.py:free_flight) computes it, and this is its plain
    version."""
    n = org.shape[0]
    if inf is None:
        inf = _full(n, float("inf"), org.dtype, org.device)
    if not isinstance(t_min, torch.Tensor):
        t_min = torch.full((n,), t_min, dtype=org.dtype, device=org.device)
    t_tri = torch.where(i_tri >= 0, t_tri, inf)

    t_best = torch.minimum(torch.minimum(t_sph, t_pln), t_tri)
    is_s = t_sph <= t_best
    is_p = t_pln <= t_best
    kind = torch.where(is_s, sp.PRIM_SPHERE,
                       torch.where(is_p, sp.PRIM_PLANE, sp.PRIM_TRIANGLE)).to(torch.int32)
    prim = torch.where(is_s, i_sph, torch.where(is_p, i_pln, i_tri))
    finite = torch.isfinite(t_best)
    kind = torch.where(finite, kind, sp.PRIM_NONE).to(torch.int32)
    prim = torch.where(finite, prim, -1).to(torch.int32)

    if pack.vol_kinds:
        t_vol, i_vol = intersect_volumes(pack, org, dirn, t_min, t_best, rng_ctx)
        vol_hit = i_vol >= 0
        t_best = torch.where(vol_hit, t_vol, t_best)
        kind = torch.where(vol_hit, sp.PRIM_VOLUME, kind).to(torch.int32)
        prim = torch.where(vol_hit, i_vol, prim).to(torch.int32)
    return t_best, kind, prim


def hit_attributes(pack, org, dirn, hit: Hit) -> HitAttributes:
    """Gather the winning primitive and compute the full hit record
    (reference: HitRecord, object.rs:32-105).  t is recomputed from the
    gathered geometry as in the reference (its differentiable form)."""
    n = org.shape[0]
    dtype, dev = org.dtype, org.device
    prim = torch.clamp(hit.prim, min=0).to(torch.int64)
    env = (hit.kind == sp.PRIM_SKY) | (hit.kind == sp.PRIM_SUN)
    one = torch.ones_like(hit.t)
    t_eval = torch.where(env | ~torch.isfinite(hit.t), one, hit.t)

    sph_affine = pack.sph_inv.shape[0] > 0
    sph_row = None
    if pack.sph_center.shape[0]:
        ns = pack.sph_center.shape[0]
        cols = [pack.sph_center, pack.sph_radius[:, None],
                pack.sph_mat.to(dtype)[:, None]]
        if sph_affine:
            cols += [pack.sph_inv.reshape(ns, 9), pack.sph_fwd.reshape(ns, 9)]
        sph_row = gather.rows(torch.cat(cols, dim=1), _clip(prim, ns), "sph_row")
        sc_ = sph_row[:, 0:3]
        if sph_affine:
            inv_ = sph_row[:, 5:14].reshape(n, 3, 3)
            oc = torch.einsum("nij,nj->ni", inv_, org - sc_)
            dl = torch.einsum("nij,nj->ni", inv_, dirn)
            a_ = vmath.length_squared(dl)
            half_b = vmath.dot(dl, oc)
            c_ = vmath.length_squared(oc) - 1.0
        else:
            sr_ = sph_row[:, 3]
            oc = org - sc_
            a_ = vmath.length_squared(dirn)
            half_b = vmath.dot(dirn, oc)
            c_ = vmath.length_squared(oc) - sr_ * sr_
        sq = vmath.safe_sqrt(half_b * half_b - a_ * c_)
        r1 = (-half_b - sq) / a_
        r2 = (-half_b + sq) / a_
        t_sph = torch.where(torch.abs(r1 - t_eval) <= torch.abs(r2 - t_eval), r1, r2)
        t_eval = torch.where(hit.kind == sp.PRIM_SPHERE, t_sph, t_eval)
    pln_row = None
    if pack.pln_corner.shape[0]:
        pln_row = gather.rows(torch.cat(
            [pack.pln_corner, pack.pln_dual_u, pack.pln_dual_v,
             pack.pln_normal, pack.pln_uhalf, pack.pln_vhalf,
             pack.pln_mat.to(dtype)[:, None]], dim=1), _clip(prim, pack.pln_corner.shape[0]),
            "pln_row")
        nrm_ = pln_row[:, 9:12]
        denom = vmath.dot(nrm_, dirn)
        t_pln = vmath.dot(nrm_, pln_row[:, 0:3] - org) / torch.where(
            denom == 0.0, torch.ones_like(denom), denom)
        t_eval = torch.where(hit.kind == sp.PRIM_PLANE, t_pln, t_eval)
    n_tri = pack.tri_v0.shape[0]
    tri_row = gather.rows(pack.tri_attr, _clip(prim, n_tri), "tri_attr") if n_tri else None
    if tri_row is not None:
        e1_ = tri_row[:, 3:6]
        e2_ = tri_row[:, 6:9]
        bq = vmath.cross(org - tri_row[:, 0:3], e1_)
        det_ = vmath.dot(e1_, vmath.cross(dirn, e2_))
        t_tri = vmath.dot(e2_, bq) / torch.where(det_ == 0.0, torch.ones_like(det_), det_)
        t_eval = torch.where(hit.kind == sp.PRIM_TRIANGLE, t_tri, t_eval)

    pos = org + dirn * t_eval[:, None]
    unit_d = vmath.normalize(dirn)

    normal = torch.zeros((n, 3), dtype=dtype, device=dev)
    tangent = torch.zeros((n, 3), dtype=dtype, device=dev)
    tangent[:, 0].fill_(1.0)
    bitangent = tangent
    uv = torch.zeros((n, 2), dtype=dtype, device=dev)
    mat = torch.zeros((n,), dtype=torch.int32, device=dev)

    if sph_row is not None:
        sc = sph_row[:, 0:3]
        if sph_affine:
            s_n = torch.einsum("nij,nj->ni", sph_row[:, 5:14].reshape(n, 3, 3), pos - sc)
            w_n = vmath.normalize(
                torch.einsum("nij,nj->ni", sph_row[:, 14:23].reshape(n, 3, 3), s_n),
                1e-20)
        else:
            s_n = (pos - sc) / sph_row[:, 3:4]
            w_n = s_n
        theta = torch.arccos(torch.clamp(s_n[:, 1], -1.0 + 1e-7, 1.0 - 1e-7))
        pole = (torch.abs(s_n[:, 0]) + torch.abs(s_n[:, 2])) < 1e-12
        phi = torch.atan2(-s_n[:, 2], torch.where(pole, torch.ones_like(s_n[:, 0]),
                                                   s_n[:, 0])) + torch.pi
        s_uv = torch.stack([phi / (2.0 * torch.pi), theta / torch.pi], dim=-1)
        s_tan = torch.stack([-s_n[:, 2], torch.zeros_like(s_n[:, 0]), -s_n[:, 0]], dim=-1)
        s_bit = vmath.cross(s_n, s_tan)
        is_s = (hit.kind == sp.PRIM_SPHERE)[:, None]
        normal = torch.where(is_s, w_n, normal)
        tangent = torch.where(is_s, s_tan, tangent)
        bitangent = torch.where(is_s, s_bit, bitangent)
        uv = torch.where(is_s, s_uv, uv)
        mat = torch.where(is_s[:, 0], sph_row[:, 4].to(torch.int32), mat)

    if pln_row is not None:
        local = pos - pln_row[:, 0:3]
        pu = vmath.dot(local, pln_row[:, 3:6])
        pv = vmath.dot(local, pln_row[:, 6:9])
        is_p = (hit.kind == sp.PRIM_PLANE)[:, None]
        normal = torch.where(is_p, pln_row[:, 9:12], normal)
        tangent = torch.where(is_p, vmath.normalize(pln_row[:, 12:15], 1e-20), tangent)
        bitangent = torch.where(is_p, vmath.normalize(pln_row[:, 15:18], 1e-20), bitangent)
        uv = torch.where(is_p, torch.stack([pu, pv], dim=-1), uv)
        mat = torch.where(is_p[:, 0], pln_row[:, 18].to(torch.int32), mat)

    if tri_row is not None:
        v0 = tri_row[:, 0:3]
        e1 = tri_row[:, 3:6]
        e2 = tri_row[:, 6:9]
        pvec = vmath.cross(dirn, e2)
        det = vmath.dot(e1, pvec)
        inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
        bvec = org - v0
        bu = vmath.dot(bvec, pvec) * inv_det
        qvec = vmath.cross(bvec, e1)
        bv = vmath.dot(dirn, qvec) * inv_det
        bw = 1.0 - bu - bv
        # interpolated shading normal, NOT renormalized (mesh.rs:107-117)
        t_n = (tri_row[:, 9:12] * bw[:, None] + tri_row[:, 12:15] * bu[:, None]
               + tri_row[:, 15:18] * bv[:, None])
        uv0, uv1, uv2 = tri_row[:, 18:20], tri_row[:, 20:22], tri_row[:, 22:24]
        t_uv = uv0 * bw[:, None] + uv1 * bu[:, None] + uv2 * bv[:, None]
        # tangent frame from UV deltas (mesh.rs:129-151)
        duv1 = uv1 - uv0
        duv2 = uv2 - uv0
        e1perp = vmath.cross(t_n, e1)
        e2perp = vmath.cross(e2, t_n)
        tan = e2perp * duv1[:, 0:1] + e1perp * duv2[:, 0:1]
        bit = e2perp * duv1[:, 1:2] + e1perp * duv2[:, 1:2]
        inv_max = 1.0 / vmath.safe_sqrt(
            torch.maximum(vmath.length_squared(tan), vmath.length_squared(bit)), 1e-20)
        has_uv = (tri_row[:, 24] > 0.5)[:, None]
        t_tan = torch.where(has_uv, tan * (-inv_max)[:, None], tangent)
        t_bit = torch.where(has_uv, bit * inv_max[:, None], tangent)
        t_uv = torch.where(has_uv, t_uv, torch.zeros_like(t_uv))
        is_t = (hit.kind == sp.PRIM_TRIANGLE)[:, None]
        normal = torch.where(is_t, t_n, normal)
        tangent = torch.where(is_t, t_tan, tangent)
        bitangent = torch.where(is_t, t_bit, bitangent)
        uv = torch.where(is_t, t_uv, uv)
        mat = torch.where(is_t[:, 0], tri_row[:, 26].to(torch.int32), mat)

    n_vol = pack.vol_kind.shape[0]
    if n_vol:
        # volume.rs:56-66: an arbitrary normal, which isotropic ignores
        is_v = hit.kind == sp.PRIM_VOLUME
        x_axis = vmath.const3((1.0, 0.0, 0.0), dtype, dev)
        normal = torch.where(is_v[:, None], x_axis, normal)
        mat = torch.where(is_v, pack.vol_mat[_clip(prim, n_vol)], mat)

    if pack.sky_tex.shape[0]:
        is_k = hit.kind == sp.PRIM_SKY
        kpole = (torch.abs(unit_d[:, 0]) + torch.abs(unit_d[:, 2])) < 1e-12
        k_u = torch.atan2(unit_d[:, 0], torch.where(kpole, torch.ones_like(unit_d[:, 2]),
                                                     unit_d[:, 2])) / (2.0 * torch.pi) + 0.5
        k_v = unit_d[:, 1] / 2.0 + 0.5
        normal = torch.where(is_k[:, None], -unit_d, normal)
        uv = torch.where(is_k[:, None], torch.stack([k_u, k_v], dim=-1), uv)

    if pack.sun_dir.shape[0]:
        is_u = hit.kind == sp.PRIM_SUN
        normal = torch.where(is_u[:, None], -unit_d, normal)

    front_face = vmath.dot(dirn, normal) < 0.0
    normal = torch.where(front_face[:, None], normal, -normal)
    valid = hit.kind != sp.PRIM_NONE
    return HitAttributes(pos=pos, normal=normal, tangent=tangent,
                         bitangent=bitangent, uv=uv, front_face=front_face,
                         mat=mat, valid=valid)
