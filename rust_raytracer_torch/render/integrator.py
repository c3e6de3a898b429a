"""Path-vertex evaluation and the wavefront compaction key (port of
rust_raytracer_tpu/render/integrator.py: `_compaction_key`, `shade_vertex`).

The bounded-loop `trace` (batch mode) and the differentiable trace are not
ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from ..ops import intersect as isect
from ..ops import shade as shd
from ..ops import texture as tex

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


def shade_vertex(pack, static, org, dirn, ctx, light_bias, alive,
                 kernel: str = "auto"):
    """One path vertex: closest hit, texture program, NEE-mixture shading,
    miss -> background.

    Returns (emission, weight, new_dir, ended, pos, stats) as the
    reference; stats["wf_overflow"] is the number of packets that
    overflowed a wavefront cap this vertex (a 0-d int64 tensor on the
    device; 0 for the exact BVH8 walk).
    """
    hit, stats = isect.intersect(pack, org, dirn, T_MIN, alive=alive, kernel=kernel,
                                 return_stats=True)
    attr = isect.hit_attributes(pack, org, dirn, hit)
    tex_values = tex.eval_program(static.tex_program, pack.tex_data, attr.uv,
                                  attr.pos, tex_const=pack.tex_const)
    res = shd.shade(pack, static.light_list, tex_values, org, dirn, hit, attr,
                    ctx, light_bias)
    miss = ~attr.valid
    emission = torch.where(miss[:, None], pack.background[None, :], res.emission)
    ended = res.terminate | miss
    return emission, res.weight, res.new_dir, ended, attr.pos, stats
