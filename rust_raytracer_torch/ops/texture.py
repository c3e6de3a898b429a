"""Texture program evaluation (port of rust_raytracer_tpu/ops/texture.py).

A scene's texture DAG is compiled host-side into a static, topologically
ordered program of `TexNode`s (scene/compiler.py).  `eval_program` evaluates
every node for all N shading points at once into a (num_nodes, N, 3) value
stack; per-ray lookups are then one gather over the node axis.

Scalar textures are carried as vec3 with the value broadcast; scalar
consumers read channel 0.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core import math as vmath

# Node type ids (same values as the reference package)
CONSTANT = 0
CHECKER = 1          # UV-space checkerboard (texture/checkerboard.rs:34-44)
CHECKER_SOLID = 2    # world-space checkerboard (texture/checkerboard.rs:74-85)
IMAGE = 3            # nearest-neighbor image sample (texture/image.rs:40-53)
LERP = 4             # interpolate two textures by a third
NOISE_SOLID = 5      # turbulence perlin + marble map (texture/noise.rs)
CHANNEL = 6          # extract one channel as scalar
UV_DEBUG = 7         # (u, v, 0.5)

REPEAT = 0
CLAMP = 1


@dataclasses.dataclass(frozen=True)
class TexNode:
    """One static node of a compiled texture program.

    `children` index earlier nodes in the program; `data_idx` indexes the
    scene pack's `tex_data` tuple (image pixels / perlin tables).
    """
    kind: int
    value: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    children: Tuple[int, ...] = ()
    scale: float = 1.0
    data_idx: int = -1
    repeat: int = REPEAT
    channel: int = 0
    samples: int = 7
    noise_map: str = "marble"
    is_scalar: bool = False


def perlin_sample(p, grad_vecs, perm_x, perm_y, perm_z):
    """Classic Perlin noise over points p (N, 3) (noise/perlin.rs:80-113)."""
    pf = torch.floor(p)
    uvw = p - pf
    ijk = pf.to(torch.int64)
    s = uvw * uvw * (3.0 - 2.0 * uvw)

    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                ix = (ijk[..., 0] + di) & 255
                iy = (ijk[..., 1] + dj) & 255
                iz = (ijk[..., 2] + dk) & 255
                gidx = perm_x[ix] ^ perm_y[iy] ^ perm_z[iz]
                g = grad_vecs[gidx.to(torch.int64)]
                w = (
                    (di * s[..., 0] + (1 - di) * (1.0 - s[..., 0]))
                    * (dj * s[..., 1] + (1 - dj) * (1.0 - s[..., 1]))
                    * (dk * s[..., 2] + (1 - dk) * (1.0 - s[..., 2]))
                )
                acc = acc + w * (g[..., 0] * (uvw[..., 0] - di)
                                 + g[..., 1] * (uvw[..., 1] - dj)
                                 + g[..., 2] * (uvw[..., 2] - dk))
    return acc


def perlin_turbulence(p, samples, grad_vecs, perm_x, perm_y, perm_z):
    """fBm turbulence |sum w_i * noise(2^i p)| (perlin.rs:101-113)."""
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight = 1.0
    pp = p
    for _ in range(samples):
        acc = acc + weight * perlin_sample(pp, grad_vecs, perm_x, perm_y, perm_z)
        weight *= 0.5
        pp = pp * 2.0
    return torch.abs(acc)


def _sample_image(pixels, u, v, repeat):
    """Nearest-neighbor image lookup (texture/image.rs:40-53)."""
    if repeat == CLAMP:
        u = torch.clamp(u, 0.0, 1.0)
        v = torch.clamp(v, 0.0, 1.0)
    else:
        u = u - torch.floor(u)
        v = v - torch.floor(v)
    h, w = pixels.shape[0], pixels.shape[1]
    x = (u * (w - 0.001)).to(torch.int64)
    y = (v * (h - 0.001)).to(torch.int64)
    return pixels[y, x]


def eval_program(program, tex_data, uv, pos, tex_const=None):
    """Evaluate all texture nodes for all shading points.

    program: tuple of TexNode; tex_data: tuple of tensors referenced by
    data_idx; uv (N, 2); pos (N, 3); tex_const: optional (num_nodes, 3)
    CONSTANT values (row i = node i), else the static node values.
    Returns the (num_nodes, N, 3) value stack.
    """
    n = uv.shape[0]
    dtype, device = pos.dtype, pos.device
    values = []
    for i, node in enumerate(program):
        if node.kind == CONSTANT:
            if tex_const is not None:
                val = tex_const[i].to(dtype).expand(n, 3)
            else:
                val = vmath.const3(node.value, dtype, device).expand(n, 3)
        elif node.kind == CHECKER:
            # rust `as u32`: truncate toward 0, saturate negatives to 0
            iu = torch.clamp(uv[..., 0] * 2.0 / node.scale, 0.0, 2.0**31).to(torch.int64)
            iv = torch.clamp(uv[..., 1] * 2.0 / node.scale, 0.0, 2.0**31).to(torch.int64)
            even = ((iu + iv) % 2 == 0)[..., None]
            val = torch.where(even, values[node.children[0]], values[node.children[1]])
        elif node.kind == CHECKER_SOLID:
            ixyz = torch.floor(pos / node.scale).to(torch.int32)
            even = (ixyz.sum(dim=-1) % 2 == 0)[..., None]
            val = torch.where(even, values[node.children[0]], values[node.children[1]])
        elif node.kind == IMAGE:
            val = _sample_image(tex_data[node.data_idx], uv[..., 0], uv[..., 1],
                                node.repeat)
        elif node.kind == LERP:
            t = values[node.children[2]][..., 0:1]
            a = values[node.children[0]]
            b = values[node.children[1]]
            val = a * (1.0 - t) + b * t
        elif node.kind == NOISE_SOLID:
            grad, px, py, pz = tex_data[node.data_idx:node.data_idx + 4]
            p_scaled = pos * node.scale
            turb = perlin_turbulence(p_scaled, node.samples, grad, px, py, pz)
            if node.noise_map == "marble":
                s = 0.5 * (1.0 + torch.sin(p_scaled[..., 2] + 10.0 * turb))
            else:
                s = turb
            val = s[..., None].expand(n, 3)
        elif node.kind == CHANNEL:
            val = values[node.children[0]][..., node.channel:node.channel + 1].expand(n, 3)
        elif node.kind == UV_DEBUG:
            val = torch.stack(
                [uv[..., 0], uv[..., 1], torch.full((n,), 0.5, dtype=dtype, device=device)],
                dim=-1,
            )
        else:
            raise ValueError(f"unknown texture node kind {node.kind}")
        values.append(val.to(dtype))
    if not values:
        return torch.zeros((1, n, 3), dtype=dtype, device=device)
    return torch.stack(values, dim=0)


def gather_values(value_stack, tex_ids):
    """Pick per-ray texture values: (T, N, 3)[tex_ids[n], n] -> (N, 3)."""
    idx = tex_ids.to(torch.int64)[None, :, None].expand(1, -1, 3)
    return torch.gather(value_stack, 0, idx)[0]
