"""Closest hits of the benchmark's plain reference.

Spheres and planes are tested one primitive at a time over all rays with a
running closest hit, as the program's plain intersector does (the parts
below from `Hit` to `hit_attributes` are a frozen copy of the same-named
functions of rust_raytracer_torch/ops/intersect.py, less volumes).  The
triangles are the reference's own: no BVH, but a two-level search that
tests every triangle of every cluster whose box a ray crosses
(`TriangleSearch`), with the Moller-Trumbore test in the program's
operation order.  It finds the closest hit exactly, as the program's exact
walks do; on equal t the lower triangle index of the reference's own order
wins, where the program's walk takes its own lowest slot.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import tables as sp
from . import vmath

T_SUN = 3.0e38
DET_EPS = 1e-12
SUN_THETA_MAX = 1e-3
# The walk's fixed lower bound on t (the program's T_MIN_STATIC).
T_MIN_STATIC = 1e-3


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
    itself in a scene without volumes; with volumes it takes this
    function's result."""
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
        sph_row = torch.cat(cols, dim=1)[_clip(prim, ns)]
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
        pln_row = torch.cat(
            [pack.pln_corner, pack.pln_dual_u, pack.pln_dual_v,
             pack.pln_normal, pack.pln_uhalf, pack.pln_vhalf,
             pack.pln_mat.to(dtype)[:, None]], dim=1)[_clip(prim, pack.pln_corner.shape[0])]
        nrm_ = pln_row[:, 9:12]
        denom = vmath.dot(nrm_, dirn)
        t_pln = vmath.dot(nrm_, pln_row[:, 0:3] - org) / torch.where(
            denom == 0.0, torch.ones_like(denom), denom)
        t_eval = torch.where(hit.kind == sp.PRIM_PLANE, t_pln, t_eval)
    n_tri = pack.tri_attr.shape[0]
    tri_row = pack.tri_attr[_clip(prim, n_tri)] if n_tri else None
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


def mt_rows(o, d, rows, best, t_min=T_MIN_STATIC):
    """Moller-Trumbore of rays (L, 1) against triangle rows (L, K, >= 10) in
    the program's operation order; (L, K) t, +inf where rejected."""
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = rows[..., 0], rows[..., 1], rows[..., 2]
    e1x, e1y, e1z = rows[..., 3], rows[..., 4], rows[..., 5]
    e2x, e2y, e2z = rows[..., 6], rows[..., 7], rows[..., 8]
    back = rows[..., 9]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    dd = torch.where(back > 0.5, torch.abs(det), det)
    ok = dd > DET_EPS
    inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    bx = o[:, 0:1] - v0x
    by = o[:, 1:2] - v0y
    bz = o[:, 2:3] - v0z
    u = (bx * px + by * py + bz * pz) * inv_det
    qx = by * e1z - bz * e1y
    qy = bz * e1x - bx * e1z
    qz = bx * e1y - by * e1x
    w = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0) & (w >= 0.0) & (u + w <= 1.0)
    ok &= (t > t_min) & (t < best[:, None])
    return torch.where(ok, t, torch.full_like(t, float("inf")))


def _slab(org, inv, lo, hi, t_max):
    """(R, B) whether each ray (R, 3) crosses each box (B, 3) within
    [T_MIN_STATIC, t_max].  A ray that lies in a box's face plane (0 * inf)
    counts as crossing, so the test never drops a box."""
    ta = (lo[None] - org[:, None]) * inv[:, None]
    tb = (hi[None] - org[:, None]) * inv[:, None]
    near = torch.minimum(torch.nan_to_num(ta, nan=-float("inf"), posinf=float("inf")),
                         torch.nan_to_num(tb, nan=-float("inf"), posinf=float("inf")))
    far = torch.maximum(torch.nan_to_num(ta, nan=float("inf"), neginf=-float("inf")),
                        torch.nan_to_num(tb, nan=float("inf"), neginf=-float("inf")))
    enter = torch.clamp(near.amax(dim=-1), min=T_MIN_STATIC)
    leave = torch.minimum(far.amin(dim=-1), t_max[:, None])
    return enter <= leave


class TriangleSearch:
    """The closest triangle of each ray by brute force over clusters.

    The triangles are ordered by the Morton code of their centroids and cut
    into clusters of CLUSTER; clusters into groups of GROUP.  A ray tests
    every group box, then the cluster boxes of the groups it crosses, then
    every triangle of the clusters it crosses.  Boxes are widened by a
    small margin, so a triangle the ray hits always lies in a box it
    crosses.  Work is done in blocks of rays, so memory stays bounded."""

    CLUSTER = 64
    GROUP = 64
    RAY_BLOCK = 4096
    PAIR_BLOCK = 1 << 16

    def __init__(self, rows: torch.Tensor):
        dev = rows.device
        n = rows.shape[0]
        self.n = n
        if n == 0:
            return
        v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        pts = torch.stack([v0, v0 + e1, v0 + e2], dim=1)
        lo_t, hi_t = pts.amin(dim=1), pts.amax(dim=1)
        cen = (lo_t + hi_t) * 0.5
        span = torch.clamp(cen.amax(0) - cen.amin(0), min=1e-20)
        q = torch.clamp((cen - cen.amin(0)) / span * 1023.0, 0, 1023).to(torch.int64)
        code = torch.zeros(n, dtype=torch.int64, device=dev)
        for bit in range(10):
            for axis in range(3):
                code |= ((q[:, axis] >> bit) & 1) << (3 * bit + 2 - axis)
        order = torch.argsort(code, stable=True)
        c = self.CLUSTER
        pad = (-n) % c
        self.tri_id = torch.cat([order, order[-1:].expand(pad)]).reshape(-1, c)
        n_cl = self.tri_id.shape[0]
        self.rows = rows[self.tri_id]                          # (n_cl, c, 10)
        margin = 1e-4 + 1e-6 * float((hi_t - lo_t).abs().max())
        self.cl_lo = lo_t[self.tri_id].amin(dim=1) - margin
        self.cl_hi = hi_t[self.tri_id].amax(dim=1) + margin
        g = self.GROUP
        gpad = (-n_cl) % g
        gid = torch.cat([torch.arange(n_cl, device=dev),
                         torch.full((gpad,), n_cl - 1, device=dev)]).reshape(-1, g)
        self.group_cl = gid
        self.gr_lo = self.cl_lo[gid].amin(dim=1)
        self.gr_hi = self.cl_hi[gid].amax(dim=1)

    def closest(self, org, dirn, t_max):
        """(t, triangle id) of each ray's closest hit in (T_MIN_STATIC,
        t_max): t_max and -1 where it hits none."""
        n = org.shape[0]
        best_t = t_max.clone()
        best_i = torch.full((n,), -1, dtype=torch.int64, device=org.device)
        if self.n == 0 or n == 0:
            return best_t, best_i
        for r0 in range(0, n, self.RAY_BLOCK):
            sl = slice(r0, min(n, r0 + self.RAY_BLOCK))
            t, i = self._block(org[sl], dirn[sl], t_max[sl])
            best_t[sl], best_i[sl] = t, i
        return best_t, best_i

    def _block(self, o, d, t_max):
        inv = 1.0 / d
        ray, grp = torch.nonzero(_slab(o, inv, self.gr_lo, self.gr_hi, t_max), as_tuple=True)
        cl = self.group_cl[grp]                                    # (P, GROUP)
        ray = ray[:, None].expand_as(cl).reshape(-1)
        cl = cl.reshape(-1)
        lo, hi = self.cl_lo[cl], self.cl_hi[cl]
        ta = (lo - o[ray]) * inv[ray]
        tb = (hi - o[ray]) * inv[ray]
        near = torch.minimum(torch.nan_to_num(ta, nan=-float("inf"), posinf=float("inf")),
                             torch.nan_to_num(tb, nan=-float("inf"), posinf=float("inf")))
        far = torch.maximum(torch.nan_to_num(ta, nan=float("inf"), neginf=-float("inf")),
                            torch.nan_to_num(tb, nan=float("inf"), neginf=-float("inf")))
        keep = (torch.clamp(near.amax(-1), min=T_MIN_STATIC)
                <= torch.minimum(far.amin(-1), t_max[ray]))
        ray, cl = ray[keep], cl[keep]
        best = t_max.clone()
        pair_t, pair_i = [], []
        for p0 in range(0, ray.shape[0], self.PAIR_BLOCK):
            r, c = ray[p0:p0 + self.PAIR_BLOCK], cl[p0:p0 + self.PAIR_BLOCK]
            tt = mt_rows(o[r], d[r], self.rows[c], t_max[r])        # (p, CLUSTER)
            tmin, k = tt.min(dim=1)
            pair_t.append(tmin)
            pair_i.append(self.tri_id[c, k])
            best.scatter_reduce_(0, r, tmin, reduce="amin")
        if not pair_t:
            return t_max, torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
        pair_t, pair_i = torch.cat(pair_t), torch.cat(pair_i)
        won = torch.isfinite(pair_t) & (pair_t == best[ray]) & (pair_t < t_max[ray])
        big = torch.iinfo(torch.int64).max
        idx = torch.full((o.shape[0],), big, dtype=torch.int64, device=o.device)
        idx.scatter_reduce_(0, ray[won], pair_i[won], reduce="amin")
        hit = idx != big
        return torch.where(hit, best, t_max), torch.where(hit, idx, -1)


def intersect(scene, search: TriangleSearch, org, dirn, t_min, rng_ctx, alive=None) -> Hit:
    """Closest hit across all primitive classes (the program's plain
    `intersect`, with the reference's own triangle search), under
    torch.no_grad(): the hits carry no gradient."""
    with torch.no_grad():
        org, dirn = org.detach(), dirn.detach()
        n = org.shape[0]
        inf = _full(n, float("inf"), org.dtype, org.device)
        t_min_lanes = torch.full((n,), t_min, dtype=org.dtype, device=org.device)
        t_sph, i_sph, t_pln, i_pln, tri_tmax = analytic_hits(scene, org, dirn, t_min_lanes,
                                                             alive, inf)
        t_tri = tri_tmax.clone()
        i_tri = torch.full((n,), -1, dtype=torch.int64, device=org.device)
        live = torch.ones_like(t_tri, dtype=torch.bool) if alive is None else alive
        live = torch.nonzero(live & (tri_tmax > 0)).squeeze(1)
        if live.numel() and search.n:
            t_tri[live], i_tri[live] = search.closest(org[live], dirn[live], tri_tmax[live])
        return close_hits(scene, org, dirn, t_min_lanes, rng_ctx, t_sph, i_sph, t_pln, i_pln,
                          t_tri, i_tri.to(torch.int32), inf)
