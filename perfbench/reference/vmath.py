"""Batched 3-vector math of the benchmark's plain reference.

A frozen copy of the same-named plain module of rust_raytracer_torch, kept
here so the reference imports nothing of the program it judges.  Do not
change it to follow the program: a change of the program's arithmetic is
what the comparison exists to catch.

Points and vectors are (..., 3) float tensors; scalars are (...,) tensors.
Dot products and cross products are written out component by component in
the reference's operation order, so results agree with XLA's to the ulp
wherever the elementwise functions do.
"""
from __future__ import annotations

import math

import torch

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length_squared(a):
    return dot(a, a)


def length(a):
    return torch.sqrt(length_squared(a))


def safe_sqrt(x, eps: float = 1e-20):
    """sqrt with the argument clamped below at eps."""
    return torch.sqrt(torch.clamp(x, min=eps))


def normalize(a, eps: float = 0.0):
    """Unit vector; `eps` > 0 guards zero length inside the sqrt."""
    if eps:
        n = torch.sqrt(torch.clamp(length_squared(a), min=eps * eps))
    else:
        n = length(a)
    return a / n[..., None]


def const3(values, dtype, device):
    """A (3,) tensor of three Python floats, written on `device` by a zero
    fill and one fill a nonzero entry: no copy from host memory, which a
    stream capturing a CUDA graph refuses (render/graphs.py)."""
    out = torch.zeros((3,), dtype=dtype, device=device)
    for i, v in enumerate(values):
        if v:
            out[i].fill_(v)
    return out




def reflect(v, n):
    """Mirror reflection about normal n (reference: vec4.rs:135-137)."""
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(unit_v, n, ior_ratio):
    """Snell refraction; assumes `unit_v` normalized (vec4.rs:140-147)."""
    cos_theta = torch.clamp(dot(-unit_v, n), max=1.0)
    if not isinstance(ior_ratio, torch.Tensor):
        ior_ratio = torch.full((), ior_ratio, dtype=unit_v.dtype, device=unit_v.device)
    r_perp = (unit_v + n * cos_theta[..., None]) * ior_ratio[..., None]
    r_par = n * (-safe_sqrt(torch.abs(1.0 - length_squared(r_perp))))[..., None]
    return r_perp + r_par


def reflectance(cos_theta, ior_ratio):
    """Schlick's approximation (reference: utils.rs:31-36)."""
    r0 = (1.0 - ior_ratio) / (1.0 + ior_ratio)
    r0 = r0 * r0
    x = 1.0 - cos_theta
    x4 = (x * x) * (x * x)
    # x**5 as XLA's integer_pow computes it: x * x^4
    return r0 + (1.0 - r0) * (x * x4)


def onb_from_vec(w):
    """Orthonormal basis (u, v, w) with w as local z (utils.rs:17-28)."""
    # a = (0, 1, 0) where |w.x| > 0.9 else (1, 0, 0)
    use_y = (torch.abs(w[..., 0]) > 0.9).to(w.dtype)
    a = torch.stack([1.0 - use_y, use_y, torch.zeros_like(use_y)], dim=-1)
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v, w


def onb_transform(u, v, w, local):
    return u * local[..., 0:1] + v * local[..., 1:2] + w * local[..., 2:3]






def square_to_unit_circle(u1, u2):
    """Uniform point on the unit circle RIM — the reference's
    `random_in_unit_disk` (vec4.rs:35-40) normalizes a 2D gaussian, which
    gives ring bokeh; reproduced exactly."""
    del u2
    phi = 2.0 * math.pi * u1
    return torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)


def square_to_uniform_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u2
    cos, sin = torch.cos(phi), torch.sin(phi)
    return torch.stack([r * cos, r * sin, z], dim=-1)


def square_to_cosine_hemisphere(u1, u2):
    """Malley cosine-weighted hemisphere about +z (vec4.rs:50-61)."""
    phi = u1 * 2.0 * math.pi
    sqrt_r2 = safe_sqrt(u2)
    cos, sin = torch.cos(phi), torch.sin(phi)
    x = cos * sqrt_r2
    y = sin * sqrt_r2
    z = safe_sqrt(1.0 - u2)
    return torch.stack([x, y, z], dim=-1)


def square_to_sphere_cone(u1, u2, cos_theta_max):
    """Uniform direction in a cone about +z (sphere.rs:123-145)."""
    phi = u1 * 2.0 * math.pi
    z = 1.0 + u2 * (cos_theta_max - 1.0)
    r = safe_sqrt(1.0 - z * z)
    cos, sin = torch.cos(phi), torch.sin(phi)
    return torch.stack([r * cos, r * sin, z], dim=-1)
