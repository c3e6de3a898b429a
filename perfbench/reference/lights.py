"""Light-sampling PDFs for next-event estimation, the benchmark's plain reference.

A frozen copy of the same-named plain module of rust_raytracer_torch, kept
here so the reference imports nothing of the program it judges.  Do not
change it to follow the program: a change of the program's arithmetic is
what the comparison exists to catch.
rust_raytracer_tpu/ops/lights.py).

Light-samplable objects are spheres (and invisible proxy spheres), planes,
sky and sun; all have closed-form pdf and sample rules, so NEE needs no BVH
traversal.  The light list is static per scene, so the loops unroll.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from . import vmath
from . import rng
from . import tables as sp
from . import hits as isect


def _sphere(pack, li, proxy):
    if proxy:
        return pack.lgt_sph_center[li], pack.lgt_sph_radius[li]
    return pack.sph_center[li], pack.sph_radius[li]


def _sphere_pdf_value(pack, li, origin, dirn, proxy=False):
    """Solid-angle cone pdf; 0 if the ray misses (sphere.rs:106-121)."""
    center, radius = _sphere(pack, li, proxy)
    t = isect.sphere_hit_t(origin, dirn, center, radius, 1e-3, float("inf"))
    hits = torch.isfinite(t)
    d2 = vmath.length_squared(center - origin)
    cos_theta_max = vmath.safe_sqrt(1.0 - radius * radius / torch.clamp(d2, min=1e-20))
    solid_angle = 2.0 * math.pi * (1.0 - cos_theta_max)
    sa_safe = torch.where(solid_angle > 0, solid_angle, torch.ones_like(solid_angle))
    return torch.where(hits & (solid_angle > 0), 1.0 / sa_safe,
                       torch.zeros_like(solid_angle))


def _sphere_sample(pack, li, origin, rng_ctx, salt, proxy=False):
    """Cone sampling toward the sphere (sphere.rs:123-145)."""
    center, radius = _sphere(pack, li, proxy)
    to_c = center - origin
    d2 = vmath.length_squared(to_c)
    cos_theta_max = vmath.safe_sqrt(1.0 - radius * radius / torch.clamp(d2, min=1e-20))
    u1, u2, _, _ = rng_ctx.uniform4(rng.Streams.LIGHT_SAMPLE + salt)
    local = vmath.square_to_sphere_cone(u1, u2, cos_theta_max)
    u, v, w = vmath.onb_from_vec(vmath.normalize(to_c, 1e-20))
    return vmath.onb_transform(u, v, w, local)


def _plane_pdf_value(pack, li, origin, dirn):
    """Area-to-solid-angle pdf (plane.rs:107-118)."""
    n = origin.shape[0]
    inf = torch.full((n,), float("inf"), dtype=origin.dtype, device=origin.device)
    t, _, _ = isect.plane_hit(
        origin, dirn, pack.pln_corner[li], pack.pln_dual_u[li],
        pack.pln_dual_v[li], pack.pln_normal[li], pack.pln_backface[li],
        1e-3, inf,
    )
    hits = torch.isfinite(t)
    t_safe = torch.where(hits, t, torch.ones_like(t))
    dist2 = t_safe * t_safe * vmath.length_squared(dirn)
    dlen = vmath.safe_sqrt(vmath.length_squared(dirn), 1e-20)
    cosine = torch.abs(vmath.dot(dirn, pack.pln_normal[li].expand_as(dirn))) / dlen
    cos_safe = torch.where(cosine > 0, cosine, torch.ones_like(cosine))
    pdf = dist2 / (cos_safe * pack.pln_area[li])
    return torch.where(hits & (cosine > 0), pdf, torch.zeros_like(pdf))


def _plane_sample(pack, li, origin, rng_ctx, salt):
    """Uniform point on the quarter-plane nearest the corner: the reference
    samples u, v in [0, 1) of the HALF vectors (plane.rs:120-126); kept."""
    u1, u2, _, _ = rng_ctx.uniform4(rng.Streams.LIGHT_SAMPLE + salt)
    p = (pack.pln_corner[li] + pack.pln_uhalf[li] * u1[..., None]
         + pack.pln_vhalf[li] * u2[..., None])
    return p - origin


def lights_pdf_value(pack, light_list: Sequence[Tuple[int, int]], origin, dirn):
    """Mean pdf over the lights list (list.rs:80-89)."""
    n = origin.shape[0]
    acc = torch.zeros((n,), dtype=origin.dtype, device=origin.device)
    if not light_list:
        return acc
    for kind, li in light_list:
        if kind == sp.LIGHT_SPHERE:
            acc = acc + _sphere_pdf_value(pack, li, origin, dirn)
        elif kind == sp.LIGHT_PROXY:
            acc = acc + _sphere_pdf_value(pack, li, origin, dirn, proxy=True)
        elif kind == sp.LIGHT_PLANE:
            acc = acc + _plane_pdf_value(pack, li, origin, dirn)
        elif kind == sp.LIGHT_SKY:
            acc = acc + 1.0 / (4.0 * math.pi)  # sky.rs:61-63
        elif kind == sp.LIGHT_SUN:
            acc = acc + 1.0  # delta-light convention, sun.rs:70-72
    return acc / len(light_list)


def lights_sample(pack, light_list: Sequence[Tuple[int, int]], origin, rng_ctx):
    """Direction toward a uniformly picked light (list.rs:91-100)."""
    n = origin.shape[0]
    n_lights = len(light_list)
    if n_lights == 0:
        return vmath.const3((1.0, 0.0, 0.0), origin.dtype, origin.device).expand(n, 3)
    pick_u = rng_ctx.uniform(rng.Streams.LIGHT_PICK)
    pick = torch.clamp((pick_u * n_lights).to(torch.int32), max=n_lights - 1)
    out = torch.zeros((n, 3), dtype=origin.dtype, device=origin.device)
    for slot, (kind, li) in enumerate(light_list):
        if kind == sp.LIGHT_SPHERE:
            d = _sphere_sample(pack, li, origin, rng_ctx, slot)
        elif kind == sp.LIGHT_PROXY:
            d = _sphere_sample(pack, li, origin, rng_ctx, slot, proxy=True)
        elif kind == sp.LIGHT_PLANE:
            d = _plane_sample(pack, li, origin, rng_ctx, slot)
        elif kind == sp.LIGHT_SKY:
            u1, u2, _, _ = rng_ctx.uniform4(rng.Streams.LIGHT_SAMPLE + slot)
            d = vmath.square_to_uniform_sphere(u1, u2)
        elif kind == sp.LIGHT_SUN:
            d = pack.sun_dir[li].expand(n, 3)
        else:
            raise ValueError(f"unknown light kind {kind}")
        out = torch.where((pick == slot)[:, None], d, out)
    return out
