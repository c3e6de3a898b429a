"""Branchless shading (port of rust_raytracer_tpu/ops/shade.py).

Every material model is evaluated for every lane and selected by material
id — a 7-way one-hot over the material table.  The NEE mixture
(camera.rs:297-315) is folded in: diffuse-type lanes sample the
light-biased mixture pdf and return the one-sample weight.

Outputs per lane: emission at this vertex, next ray direction, throughput
weight and a terminate flag.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch

from ..core import math as vmath
from ..core import rng
from ..scene import pack as sp
from . import gather
from . import intersect as isect
from . import lights as lt
from . import texture as tex


class ShadeResult(NamedTuple):
    emission: torch.Tensor   # (N, 3)
    new_dir: torch.Tensor    # (N, 3) next direction (unnormalized, like the reference)
    weight: torch.Tensor     # (N, 3) throughput multiplier
    terminate: torch.Tensor  # (N,) bool


def _random_unit(rng_ctx, stream):
    """Uniform unit vector via a normalized gaussian (vec4.rs:42-48)."""
    gx, gy, gz = rng_ctx.gaussian3(stream)
    return vmath.normalize(torch.stack([gx, gy, gz], dim=-1), 1e-20)


def _cosine_about(normal, rng_ctx, stream):
    """Cosine-weighted direction about `normal` (pdf/cosine.rs)."""
    u1, u2, _, _ = rng_ctx.uniform4(stream)
    local = vmath.square_to_cosine_hemisphere(u1, u2,
                                              exact32=normal.dtype == torch.float64)
    u, v, w = vmath.onb_from_vec(normal)
    return vmath.onb_transform(u, v, w, local)


def shade(pack, light_list: Sequence[Tuple[int, int]], tex_values, org, dirn,
          hit: isect.Hit, attr: isect.HitAttributes, rng_ctx,
          light_bias: float) -> ShadeResult:
    n = org.shape[0]
    dtype, dev = org.dtype, org.device
    zeros3 = torch.zeros((n, 3), dtype=dtype, device=dev)

    unit_dir = vmath.normalize(dirn, 1e-20)

    mrow = gather.rows(torch.cat(
        [pack.mat_type.to(dtype)[:, None], pack.mat_albedo_tex.to(dtype)[:, None],
         pack.mat_rough_tex.to(dtype)[:, None], pack.mat_inv_ior[:, None],
         pack.mat_ior[:, None], pack.mat_normal_tex.to(dtype)[:, None]],
        dim=1), attr.mat.to(torch.int64), "mrow")
    mtype = mrow[:, 0].to(torch.int32)
    albedo = tex.gather_values(tex_values, mrow[:, 1].to(torch.int32))
    rough = tex.gather_values(tex_values, mrow[:, 2].to(torch.int32))[:, 0]
    inv_ior = mrow[:, 3]
    ior = mrow[:, 4]
    normal_tex = mrow[:, 5].to(torch.int32)

    # ---- normal mapping (glossy.rs:35-50) ----
    has_nm = normal_tex >= 0
    nm_sample = tex.gather_values(tex_values, torch.clamp(normal_tex, min=0))
    d = nm_sample - 0.5
    mapped = (attr.tangent * d[:, 0:1] + attr.bitangent * d[:, 1:2]
              + attr.normal * d[:, 2:3])
    mapped = vmath.normalize(mapped, 1e-20)
    nrm_mapped = torch.where(has_nm[:, None], mapped, attr.normal)

    # ---- emission ----
    env = (hit.kind == sp.PRIM_SKY) | (hit.kind == sp.PRIM_SUN)
    is_emissive = (mtype == sp.MAT_EMISSIVE) & attr.valid & ~env
    emission = torch.where((is_emissive & attr.front_face)[:, None], albedo, zeros3)
    is_debug = (mtype == sp.MAT_NORMAL_DEBUG) & attr.valid & ~env
    emission = torch.where(is_debug[:, None], nrm_mapped * 0.5 + 0.5, emission)
    prim = torch.clamp(hit.prim, min=0).to(torch.int64)
    if pack.sky_tex.shape[0]:
        sky_emit = tex.gather_values(tex_values, pack.sky_tex[isect._clip(prim, pack.sky_tex.shape[0])])
        emission = torch.where((hit.kind == sp.PRIM_SKY)[:, None], sky_emit, emission)
    if pack.sun_dir.shape[0]:
        sun_emit = tex.gather_values(tex_values, pack.sun_tex[isect._clip(prim, pack.sun_tex.shape[0])])
        emission = torch.where((hit.kind == sp.PRIM_SUN)[:, None], sun_emit, emission)

    # ---- specular family: metal / dielectric / glossy-specular ----
    is_metal = mtype == sp.MAT_METAL
    is_dielectric = mtype == sp.MAT_DIELECTRIC
    is_glossy = mtype == sp.MAT_GLOSSY
    is_lambert = mtype == sp.MAT_LAMBERTIAN
    is_iso = mtype == sp.MAT_ISOTROPIC

    g_cos = torch.clamp(vmath.dot(-unit_dir, nrm_mapped), max=1.0)
    g_refl = vmath.reflectance(g_cos, inv_ior)
    u_fresnel = rng_ctx.uniform(rng.Streams.FRESNEL)
    glossy_spec = is_glossy & (g_refl > u_fresnel)

    spec_n = torch.where(is_metal[:, None], attr.normal, nrm_mapped)
    reflected = vmath.reflect(dirn, spec_n)
    fuzz = _random_unit(rng_ctx, rng.Streams.SPECULAR)
    refl_len = vmath.safe_sqrt(vmath.length_squared(reflected))
    fuzzy_dir = reflected + fuzz * (rough * refl_len)[:, None]
    fuzz_ok = vmath.dot(fuzzy_dir, spec_n) > 0.0

    # dielectric (dielectric.rs:30-53)
    di_ratio = torch.where(attr.front_face, 1.0 / ior, ior)
    di_cos = torch.clamp(vmath.dot(-unit_dir, attr.normal), max=1.0)
    di_sin = vmath.safe_sqrt(1.0 - di_cos * di_cos)
    tir = di_ratio * di_sin > 1.0
    di_reflect = tir | (vmath.reflectance(di_cos, di_ratio) > u_fresnel)
    di_dir = torch.where(
        di_reflect[:, None],
        vmath.reflect(unit_dir, attr.normal),
        vmath.refract(unit_dir, attr.normal, di_ratio),
    )

    # ---- pdf family: lambertian / isotropic / glossy-diffuse, NEE mix ----
    pdf_family = is_lambert | is_iso | (is_glossy & ~glossy_spec)
    cos_n = torch.where(is_lambert[:, None], attr.normal, nrm_mapped)

    mat_dir = torch.where(
        is_iso[:, None],
        _random_unit(rng_ctx, rng.Streams.MAT_SAMPLE),
        _cosine_about(cos_n, rng_ctx, rng.Streams.MAT_SAMPLE),
    )
    light_dir = lt.lights_sample(pack, light_list, attr.pos, rng_ctx)
    u_mix = rng_ctx.uniform(rng.Streams.MIX_CHOICE)
    use_light = (u_mix < light_bias) & (len(light_list) > 0)
    nee_dir = torch.where(use_light[:, None], light_dir, mat_dir)

    unit_nee = vmath.normalize(nee_dir, 1e-20)
    cos_pdf = torch.clamp(vmath.dot(unit_nee, cos_n), min=0.0) / math.pi
    iso_pdf = torch.full((n,), 1.0 / (4.0 * math.pi), dtype=dtype, device=dev)
    mat_pdf_val = torch.where(is_iso, iso_pdf, cos_pdf)
    if light_list:
        light_pdf_val = lt.lights_pdf_value(pack, light_list, attr.pos, nee_dir)
        pdf_val = mat_pdf_val * (1.0 - light_bias) + light_pdf_val * light_bias
    else:
        pdf_val = mat_pdf_val

    scat_pdf = torch.where(is_iso, iso_pdf,
                           torch.clamp(vmath.dot(unit_nee, cos_n), min=0.0) / math.pi)

    pos_pdf = pdf_val > 0.0
    safe_pdf = torch.where(pos_pdf, pdf_val, torch.ones_like(pdf_val))
    pdf_weight = albedo * (scat_pdf / safe_pdf)[:, None]
    pdf_weight = torch.where(pos_pdf[:, None], pdf_weight, zeros3)

    # ---- combine ----
    spec_lane = is_metal | glossy_spec
    new_dir = torch.where(pdf_family[:, None], nee_dir, zeros3)
    new_dir = torch.where(spec_lane[:, None], fuzzy_dir, new_dir)
    new_dir = torch.where(is_dielectric[:, None], di_dir, new_dir)

    weight = torch.where(pdf_family[:, None], pdf_weight, zeros3)
    weight = torch.where((is_metal & fuzz_ok)[:, None], albedo, weight)
    weight = torch.where((glossy_spec & fuzz_ok)[:, None], 1.0, weight)
    weight = torch.where(is_dielectric[:, None], 1.0, weight)

    absorbed = spec_lane & ~fuzz_ok
    terminate = (~attr.valid | is_emissive | is_debug
                 | (hit.kind == sp.PRIM_SKY) | (hit.kind == sp.PRIM_SUN) | absorbed)
    weight = torch.where(terminate[:, None], 0.0, weight)

    return ShadeResult(emission=emission, new_dir=new_dir, weight=weight,
                       terminate=terminate)
