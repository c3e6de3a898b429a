"""Camera model and ray generation of the benchmark's plain reference.

A frozen copy of the same-named plain module of rust_raytracer_torch, kept
here so the reference imports nothing of the program it judges.  Do not
change it to follow the program: a change of the program's arithmetic is
what the comparison exists to catch.

`Camera` precomputes the view geometry on the host in float64 numpy exactly
as the reference's `Camera::init` (camera.rs:86-130); `generate_rays` is the
batched `get_ray` (camera.rs:260-280) on tensors: stratified jittered pixel
samples plus an optional defocus origin.

Parity quirks kept: the basis u = v_up x w, v = w x u is NOT normalized
(camera.rs:100-104); the aperture samples the unit-circle rim (ring bokeh,
vec4.rs:35-40); spp quantizes to threads * floor(sqrt(spp/threads))^2
(config.rs:154-155).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import vmath
from . import rng as vrng


@dataclasses.dataclass
class Camera:
    image_width: int = 600
    aspect_ratio: float = 1.5
    focal_length: float = 50.0
    f_number: Optional[float] = None
    focus_distance: Optional[float] = None
    position: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    look_at: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    v_up: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    samples_per_pixel: int = 250
    max_depth: int = 20
    light_bias: float = 0.25
    thread_count: int = 1  # kept for spp-quantization parity only

    def __post_init__(self):
        self.image_height = max(1, int(self.image_width / self.aspect_ratio))

        pos = np.asarray(self.position, np.float64)
        target = np.asarray(self.look_at, np.float64)
        vup = np.asarray(self.v_up, np.float64)

        direction = pos - target
        focus_dist = (
            self.focus_distance
            if self.focus_distance is not None
            else float(np.linalg.norm(direction))
        )
        h = 24.0 / self.focal_length
        real_aspect = self.image_width / self.image_height
        viewport_h = focus_dist * h
        viewport_w = viewport_h * real_aspect

        w = direction / np.linalg.norm(direction)
        u = np.cross(vup, w)   # NOT normalized — parity with camera.rs:102
        v = np.cross(w, u)
        self.basis = (u, v, w)

        viewport_u = u * viewport_w
        viewport_v = -v * viewport_h
        self.pixel_delta_u = viewport_u / self.image_width
        self.pixel_delta_v = viewport_v / self.image_height
        upper_left = pos - w * focus_dist - viewport_u / 2.0 - viewport_v / 2.0
        self.first_pixel = upper_left + (self.pixel_delta_u + self.pixel_delta_v) * 0.5

        self.aperture_radius = (
            (self.focal_length / 1000.0) / self.f_number
            if self.f_number is not None
            else None
        )

        spt = max(1, self.samples_per_pixel // self.thread_count)
        self.sqrt_spt = max(1, int(math.sqrt(spt)))
        self.actual_spp = self.thread_count * self.sqrt_spt * self.sqrt_spt
        self._consts = {}

    def generate_rays(self, px, py, sample_id, rng_ctx, dtype=torch.float32):
        """Batched `get_ray`: (N,) integer pixel coords + sample ids ->
        (org, dir) of `dtype` (float32, or float64 for the validation
        trace) on the device of `px`.  The jitter uniforms are f32 at any
        dtype and promote, as the reference's (core/rng.py).

        Within each virtual thread, sample j maps to the (sx, sy) cell of a
        sqrt_spt x sqrt_spt grid (camera.rs:334-341).
        """
        dev = px.device
        key = (dev, dtype)
        if key not in self._consts:
            # host geometry as device tensors of `dtype`, copied once per
            # device and dtype
            self._consts[key] = {
                k: torch.tensor(np.asarray(getattr(self, k), np.float64),
                                dtype=dtype, device=dev)
                for k in ("position", "first_pixel", "pixel_delta_u",
                          "pixel_delta_v")
            }
            self._consts[key]["bu"] = torch.tensor(self.basis[0], dtype=dtype, device=dev)
            self._consts[key]["bv"] = torch.tensor(self.basis[1], dtype=dtype, device=dev)
        const = self._consts[key]

        spt = self.sqrt_spt * self.sqrt_spt
        j = sample_id % spt
        sx = (j % self.sqrt_spt).to(dtype)
        sy = (j // self.sqrt_spt).to(dtype)
        inv_sqrt_spt = 1.0 / self.sqrt_spt

        jx, jy, _, _ = rng_ctx.uniform4(vrng.Streams.PIXEL_JITTER)
        ox = (sx + jx) * inv_sqrt_spt - 0.5
        oy = (sy + jy) * inv_sqrt_spt - 0.5

        pos = const["position"]
        pixel_sample = (
            const["first_pixel"]
            + const["pixel_delta_u"] * (px.to(dtype) + ox)[:, None]
            + const["pixel_delta_v"] * (py.to(dtype) + oy)[:, None]
        )

        if self.aperture_radius is not None:
            c1, c2, _, _ = rng_ctx.uniform4(vrng.Streams.APERTURE)
            rim = vmath.square_to_unit_circle(c1, c2)
            org = pos + (
                const["bu"] * rim[:, 0:1] + const["bv"] * rim[:, 1:2]
            ) * self.aperture_radius
        else:
            org = pos.expand(pixel_sample.shape)

        return org, pixel_sample - org
