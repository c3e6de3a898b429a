"""Film: accumulation buffer + image output (port of
rust_raytracer_tpu/render/film.py).

The accumulator is a host (H, W, 3) float64 buffer of radiance sums;
`to_image` divides by the sample count, tonemaps (ACES by default),
converts to sRGB and quantizes — the reference's output.rs chain.  Images
are written as binary P6 PPM or as PNG through a small stdlib (zlib +
struct) encoder, so no imaging library is needed.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..ops import tonemap as tm
from ..utils import metrics as metricsmod


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
        _png_chunk(b"IEND", b""),
    ])


class Film:
    """Host-side float64 accumulation, like the reference (buffer.rs)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.accum = np.zeros((height, width, 3), np.float64)
        self.samples = 0

    def add_samples(self, radiance_sum, n_samples: int):
        """Add a (H, W, 3) radiance *sum* over n_samples per pixel: spans
        `film.to_host` (a tensor's copy home) and `film.add`."""
        if isinstance(radiance_sum, torch.Tensor):
            with metricsmod.span("film.to_host"):
                radiance_sum = radiance_sum.detach().cpu().numpy()
        with metricsmod.span("film.add"):
            self.accum = self.accum + np.asarray(radiance_sum, np.float64)
        self.samples += n_samples

    def hdr(self) -> np.ndarray:
        """Mean radiance per pixel."""
        return self.accum / max(1, self.samples)

    def to_image(self, tonemap: str = "aces") -> np.ndarray:
        """(H, W, 3) uint8 via tonemap -> sRGB -> quantize (output.rs:23-39)."""
        color = torch.from_numpy(self.hdr().astype(np.float32))
        color = tm.linear_to_srgb(tm.TONEMAPS[tonemap](color))
        return tm.quantize_u8(color).numpy()

    def save(self, path: str, tonemap: str = "aces"):
        """Write a .ppm (binary P6) or, otherwise, a PNG."""
        if path.endswith(".ppm"):
            return self.save_ppm(path, tonemap)
        with open(path, "wb") as f:
            f.write(encode_png(self.to_image(tonemap)))
        return path

    def save_ppm(self, path: str, tonemap: str = "aces"):
        """Binary P6 PPM through the standard tonemap chain."""
        img = self.to_image(tonemap)
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (self.width, self.height) + img.tobytes())
        return path

    def save_ppm_p3(self, path: str):
        """ASCII P3 PPM with gamma 1/2.2, the reference's legacy writer
        (ppm.rs:9-38): per channel (clamp(x^(1/2.2), 0, 1) * 255.999) as
        u8, row-major, one 'r g b' line per pixel, from the raw buffer (no
        ACES/sRGB chain)."""
        mapped = np.clip(np.power(np.maximum(self.hdr(), 0.0), 1.0 / 2.2), 0.0, 1.0)
        q = (mapped * 255.999).astype(np.uint8)
        with open(path, "w") as f:
            f.write(f"P3\n{self.width} {self.height}\n255\n")
            f.write("".join(f"{r} {g} {b}\n" for r, g, b in q.reshape(-1, 3)))
        return path
