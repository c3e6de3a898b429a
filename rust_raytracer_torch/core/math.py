"""Batched 3-vector math (port of rust_raytracer_tpu/core/math.py).

Points and vectors are (..., 3) float tensors; scalars are (...,) tensors.
Dot products and cross products are written out component by component in
the reference's operation order, so results agree with XLA's to the ulp
wherever the elementwise functions do.
"""
from __future__ import annotations

import math

import torch

EPS_NEAR_ZERO = 1e-8


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


def lerp(a, b, t):
    if not isinstance(t, torch.Tensor):
        t = torch.full((), t, dtype=a.dtype, device=a.device)
    if t.ndim < a.ndim:
        t = t[..., None]
    return a * (1.0 - t) + b * t


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


def near_zero(a):
    return torch.all(torch.abs(a) < EPS_NEAR_ZERO, dim=-1)


def deg_to_rad(degrees):
    return degrees / 180.0 * math.pi


# ---------------------------------------------------------------------------
# f32 functions of the RNG's f32 uniforms in the f64 validation trace.  The
# reference computes them in f32 at any trace dtype, on the CPU through
# glibc's sinf/cosf, a correctly rounded sqrt and a fused multiply-add; the
# f64 trace of the port computes the same f32 values from f64 operations, so
# they are equal on the CPU and the card, and to the reference's.  The f32
# trace keeps torch's own f32 functions.
# ---------------------------------------------------------------------------

# glibc's sincosf constants (sysdeps/ieee754/flt-32/s_sincosf_data.c)
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")  # 2 / pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")
_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))


def _top12(bits: int) -> int:
    return (bits >> 20) & 0x7FF


_TOP12_PIO4 = _top12(0x3F490FDB)    # f32 pi / 4
_TOP12_TINY = _top12(0x39800000)    # 0x1p-12f
_TOP12_120 = _top12(0x42F00000)     # 120.0f


def cos_sin32(phi):
    """(cos, sin) of the f32 tensor `phi` as f32, equal to glibc's cosf and
    sinf for |phi| < 120 (the sampling angles are in [0, 2 pi)); beyond, the
    f64 cos and sin rounded to f32."""
    top = (phi.view(torch.int32) >> 20) & 0x7FF
    x = phi.double()
    small = top < _TOP12_PIO4
    r = x * _HPI_INV
    n = torch.where(small, 0, ((r.to(torch.int32) + 0x800000) >> 24))
    xr = torch.where(small, x, x - n.double() * _HPI)
    sign = torch.where(((n & 3) == 1) | ((n & 3) == 2), -1.0, 1.0).double()
    xs = xr * sign
    x2 = xr * xr
    # sine polynomial on xs, cosine polynomial on x2 (coefficients negated
    # in quadrants 2 and 3, glibc's second table)
    x3 = xs * x2
    s1 = _S[1] + x2 * _S[2]
    x7 = x3 * x2
    p_sin = (xs + x3 * _S[0]) + x7 * s1
    flip = torch.where((n & 2) != 0, -1.0, 1.0).double()
    x4 = x2 * x2
    c2 = _C[3] * flip + x2 * (_C[4] * flip)
    c1 = _C[0] * flip + x2 * (_C[1] * flip)
    x6 = x4 * x2
    p_cos = (c1 + x4 * (_C[2] * flip)) + x6 * c2
    odd = (n & 1) != 0
    cos = torch.where(odd, p_sin, p_cos)
    sin = torch.where(odd, p_cos, p_sin)
    tiny = top < _TOP12_TINY
    cos = torch.where(tiny, 1.0, cos)
    sin = torch.where(tiny, x, sin)
    big = top >= _TOP12_120
    cos = torch.where(big, torch.cos(x), cos)
    sin = torch.where(big, torch.sin(x), sin)
    return cos.float(), sin.float()


def sqrt32(x):
    """Correctly rounded f32 sqrt of an f32 tensor (sqrt in f64, rounded)."""
    return torch.sqrt(x.double()).float()


def safe_sqrt32(x, eps: float = 1e-20):
    return sqrt32(torch.clamp(x, min=eps))


def _cos_sin(phi, exact32):
    return cos_sin32(phi) if exact32 else (torch.cos(phi), torch.sin(phi))


def square_to_unit_circle(u1, u2, exact32: bool = False):
    """Uniform point on the unit circle RIM — the reference's
    `random_in_unit_disk` (vec4.rs:35-40) normalizes a 2D gaussian, which
    gives ring bokeh; reproduced exactly.  `exact32` (the f64 trace)
    computes the f32 values as the reference's CPU build does (cos_sin32)."""
    del u2
    phi = 2.0 * math.pi * u1
    return torch.stack(_cos_sin(phi, exact32), dim=-1)


def square_to_uniform_sphere(u1, u2, exact32: bool = False):
    z = 1.0 - 2.0 * u1
    if exact32:
        # 1 - z * z fused into one rounding, as the reference's CPU build
        r = safe_sqrt32((1.0 - z.double() * z.double()).float())
    else:
        r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u2
    cos, sin = _cos_sin(phi, exact32)
    return torch.stack([r * cos, r * sin, z], dim=-1)


def square_to_cosine_hemisphere(u1, u2, exact32: bool = False):
    """Malley cosine-weighted hemisphere about +z (vec4.rs:50-61)."""
    phi = u1 * 2.0 * math.pi
    root = safe_sqrt32 if exact32 else safe_sqrt
    sqrt_r2 = root(u2)
    cos, sin = _cos_sin(phi, exact32)
    x = cos * sqrt_r2
    y = sin * sqrt_r2
    z = root(1.0 - u2)
    return torch.stack([x, y, z], dim=-1)


def square_to_sphere_cone(u1, u2, cos_theta_max, exact32: bool = False):
    """Uniform direction in a cone about +z (sphere.rs:123-145)."""
    phi = u1 * 2.0 * math.pi
    z = 1.0 + u2 * (cos_theta_max - 1.0)
    r = safe_sqrt(1.0 - z * z)
    cos, sin = _cos_sin(phi, exact32)
    return torch.stack([r * cos, r * sin, z], dim=-1)
