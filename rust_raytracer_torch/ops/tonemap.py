"""Tonemapping and colour transforms (port of rust_raytracer_tpu/ops/tonemap.py)."""
from __future__ import annotations

import torch

# sRGB => XYZ => D65_2_D60 => AP1 => RRT_SAT (reference: aces.rs:5-10)
_ACES_INPUT = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)

# ODT_SAT => XYZ => D60_2_D65 => sRGB (reference: aces.rs:13-18)
_ACES_OUTPUT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)


def _apply(m, color):
    mat = torch.tensor(m, dtype=torch.float32, device=color.device).to(color.dtype)
    return torch.einsum("ij,...j->...i", mat, color)


def _rrt_and_odt_fit(v):
    """Narkowicz rational-polynomial fit (reference: aces.rs:20-24)."""
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (v * 0.983729 + 0.4329510) + 0.238081
    return a / b


def tonemap_aces(color):
    """ACES filmic tonemap (reference: aces.rs:27-33); color (..., 3)."""
    c = _rrt_and_odt_fit(_apply(_ACES_INPUT, color))
    return torch.clamp(_apply(_ACES_OUTPUT, c), 0.0, 1.0)


def tonemap_clamp(color):
    return torch.clamp(color, 0.0, 1.0)


TONEMAPS = {"aces": tonemap_aces, "clamp": tonemap_clamp}

_SRGB_GAMMA = 1.0 / 2.4


def linear_to_srgb(color):
    """Exact piecewise sRGB EOTF (reference: output.rs:42-50)."""
    lo = color * 12.92
    hi = torch.pow(torch.clamp(color, min=1e-12), _SRGB_GAMMA) * 1.055 - 0.055
    return torch.where(color < 0.0031308, lo, hi)


def quantize_u8(color):
    """[0, 1] float -> u8 with the reference's *255.999 truncation
    (output.rs:29-33)."""
    return torch.clamp(color * 255.999, 0.0, 255.0).to(torch.uint8)
