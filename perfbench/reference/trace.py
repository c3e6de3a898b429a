"""The path integrator of the benchmark's plain reference: rays in, the
radiance of each path out, one sample a lane.

`shade_hits` and `advance` are frozen copies of the program's plain
`integrator.shade_hits` and `_advance` (rust_raytracer_torch/render/
integrator.py).  `radiance` follows each lane to the end of its path, as
the program's pool and batch renders do: the RNG is keyed by (pixel,
sample, bounce), so a lane's path does not depend on the schedule that
traced it, and lanes are traced in no particular order (dead lanes are
dropped).  `radiance_differentiable` runs every bounce on every lane with
the hits detached, as the program's differentiable trace does without
compaction.

`rounding`, if given, is applied to the lane state (origin, direction,
throughput, radiance) after the camera and after every bounce: the control
that stores the lane state in a lower precision.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import hits as isect
from . import rng as vrng
from . import shade as shd
from . import texture as tex
from . import vmath

T_MIN = 1e-3


def shade_hits(scene, org, dirn, hit, ctx, light_bias):
    """Hit record, texture program, NEE-mixture shading, miss ->
    background; (emission, weight, new_dir, ended, pos)."""
    attr = isect.hit_attributes(scene, org, dirn, hit)
    unit_z = vmath.const3((0.0, 0.0, 1.0), org.dtype, org.device)
    attr = attr._replace(normal=torch.where(attr.valid[:, None], attr.normal, unit_z))
    tex_values = tex.eval_program(scene.tex_program, attr.uv, attr.pos,
                                  tex_const=scene.tex_const)
    res = shd.shade(scene, scene.light_list, tex_values, org, dirn, hit, attr, ctx,
                    light_bias)
    miss = ~attr.valid
    emission = torch.where(miss[:, None], scene.background[None, :], res.emission)
    ended = res.terminate | miss
    return emission, res.weight, res.new_dir, ended, attr.pos


def advance(org, dirn, throughput, radiance, alive, emission, weight, next_dir, ended, pos):
    radiance = radiance + throughput * emission * alive[:, None]
    throughput = throughput * torch.where(alive[:, None], weight, 0.0)
    alive = alive & ~ended
    new_org = torch.where(alive[:, None], pos, org)
    new_dir = torch.where(alive[:, None], next_dir, dirn)
    return new_org, new_dir, throughput, radiance, alive


def _keep(x):
    return x


def radiance(scene, search, camera, px, py, sample, seed, max_depth: int,
             rounding: Optional[Callable] = None):
    """(N, 3) radiance of one sample a lane: camera rays for pixels (px, py)
    and sample ids (int64 tensors), traced to the end of their paths; `seed`
    an int, or an int64 tensor of one seed a lane."""
    rnd = rounding or _keep
    with torch.no_grad():
        pixel = vrng.as_u32(py * camera.image_width + px)
        sample = vrng.as_u32(sample)
        ctx = vrng.Ctx(pixel=pixel, sample=sample, bounce=0, seed=seed)
        org, dirn = camera.generate_rays(px, py, sample, ctx)
        n = org.shape[0]
        org, dirn = rnd(org.contiguous()), rnd(dirn)
        throughput = torch.ones((n, 3), dtype=org.dtype, device=org.device)
        rad = torch.zeros_like(throughput)
        lane = torch.arange(n, device=org.device)
        out = torch.zeros_like(throughput)
        for depth in range(max_depth):
            if lane.numel() == 0:
                break
            sd = seed[lane] if isinstance(seed, torch.Tensor) else seed
            ctx = vrng.Ctx(pixel=pixel[lane], sample=sample[lane], bounce=depth, seed=sd)
            alive = torch.ones(lane.shape, dtype=torch.bool, device=org.device)
            hit = isect.intersect(scene, search, org, dirn, T_MIN, ctx, alive=alive)
            shaded = shade_hits(scene, org, dirn, hit, ctx, camera.light_bias)
            org, dirn, throughput, rad, alive = advance(org, dirn, throughput, rad, alive,
                                                        *shaded)
            org, dirn, throughput, rad = rnd(org), rnd(dirn), rnd(throughput), rnd(rad)
            done = ~alive
            out[lane[done]] = rad[done]
            keep = torch.nonzero(alive).squeeze(1)
            lane, org, dirn, throughput, rad = (x[keep] for x in (lane, org, dirn, throughput,
                                                                   rad))
        out[lane] = rad
    return out


def radiance_differentiable(scene, search, camera, px, py, sample, seed: int, max_depth: int,
                            rounding: Optional[Callable] = None):
    """`radiance` with every bounce run on every lane (no early exit), the
    hits detached: differentiable in the scene's float tables."""
    rnd = rounding or _keep
    pixel = vrng.as_u32(py * camera.image_width + px)
    sample = vrng.as_u32(sample)
    ctx = vrng.Ctx(pixel=pixel, sample=sample, bounce=0, seed=seed)
    org, dirn = camera.generate_rays(px, py, sample, ctx)
    n = org.shape[0]
    org, dirn = rnd(org.contiguous()), rnd(dirn)
    throughput = torch.ones((n, 3), dtype=org.dtype, device=org.device)
    rad = torch.zeros_like(throughput)
    alive = torch.ones((n,), dtype=torch.bool, device=org.device)
    for depth in range(max_depth):
        ctx = vrng.Ctx(pixel=pixel, sample=sample, bounce=depth, seed=seed)
        hit = isect.intersect(scene, search, org, dirn, T_MIN, ctx, alive=alive)
        shaded = shade_hits(scene, org, dirn, hit, ctx, camera.light_bias)
        org, dirn, throughput, rad, alive = advance(org, dirn, throughput, rad, alive, *shaded)
        org, dirn, throughput, rad = rnd(org), rnd(dirn), rnd(throughput), rnd(rad)
    return rad


def to_bfloat16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and kept in its own dtype: the control's
    storage precision."""
    return x.to(torch.bfloat16).to(x.dtype)
