"""Counter-based RNG (pcg4d) of the benchmark's plain reference.

A frozen copy of the same-named plain module of rust_raytracer_torch, kept
here so the reference imports nothing of the program it judges.  Do not
change it to follow the program: a change of the program's arithmetic is
what the comparison exists to catch.

Every draw is keyed by integer coordinates (pixel/sample counter, bounce,
stream id, seed) and hashed with pcg4d [Jarzynski & Olano, "Hash Functions
for GPU Rendering", JCGT 2020], so renders are deterministic and independent
of lane order, and every draw equals the JAX package's bit for bit.

PyTorch has no usable uint32 arithmetic (add and >> raise on the CPU), so
u32 values live in int64 tensors holding [0, 2^32): every multiply and add
is masked back to 32 bits with `& 0xFFFFFFFF`.  The product of two u32
values may wrap int64; its low 32 bits are still exact in two's complement.
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
# 1/2^32 — converts 32 random bits into [0, 1).
_INV_U32 = 2.3283064365386963e-10


def as_u32(x):
    """Integer tensor or Python int -> its u32 value (int64 tensor or int).
    Python ints stay ints, so scalar keys never become device copies."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _lcg(x):
    return (x * 1664525 + 1013904223) & _M32


def _mix(a, b, c):
    return (a + b * c) & _M32


def _pcg4d(a, b, c, d):
    """pcg4d hash: 4 x u32 in, 4 x u32 of white noise out (int64 tensors)."""
    v0, v1, v2, v3 = _lcg(a), _lcg(b), _lcg(c), _lcg(d)

    v0 = _mix(v0, v1, v3)
    v1 = _mix(v1, v2, v0)
    v2 = _mix(v2, v0, v1)
    v3 = _mix(v3, v1, v2)

    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)

    v0 = _mix(v0, v1, v3)
    v1 = _mix(v1, v2, v0)
    v2 = _mix(v2, v0, v1)
    v3 = _mix(v3, v1, v2)
    return v0, v1, v2, v3


def random_bits4(lane, bounce, stream, seed):
    """4 independent u32 streams (int64 tensors) keyed by
    (lane, bounce, stream, seed).  Args are tensors or Python ints (at
    least one a tensor) and broadcast; values are taken modulo 2^32, as
    the reference's cast to uint32."""
    bits = _pcg4d(*(as_u32(x) for x in (lane, bounce, stream, seed)))
    return torch.broadcast_tensors(*bits)


def _to_unit(v):
    # int64 -> f32 rounds to nearest like the reference's u32 -> f32, so
    # draws >= 2^32 - 128 round up to exactly 1.0 (rng.py:63)
    return v.to(torch.float32) * _INV_U32


def uniform4(lane, bounce, stream, seed):
    """4 independent uniforms in [0, 1] keyed by integer coordinates."""
    return tuple(_to_unit(v) for v in random_bits4(lane, bounce, stream, seed))


def uniform(lane, bounce, stream, seed):
    return uniform4(lane, bounce, stream, seed)[0]


STREAM_STRIDE = 4096


class Streams:
    """Stream ids: every distinct decision draws from its own stream."""
    PIXEL_JITTER = 0
    APERTURE = 1
    MIX_CHOICE = 2
    MAT_SAMPLE = 3
    LIGHT_PICK = 4
    LIGHT_SAMPLE = 5
    SPECULAR = 6
    FRESNEL = 7
    VOLUME = 8
    RUSSIAN_ROULETTE = 9




def _box_muller3(u1, u2, u3, u4):
    u1 = torch.clamp(u1, min=1e-10)
    u3 = torch.clamp(u3, min=1e-10)
    r1 = torch.sqrt(-2.0 * torch.log(u1))
    r2 = torch.sqrt(-2.0 * torch.log(u3))
    t1 = 2.0 * math.pi * u2
    t2 = 2.0 * math.pi * u4
    return r1 * torch.cos(t1), r1 * torch.sin(t1), r2 * torch.cos(t2)


class Ctx:
    """RNG key context: (pixel lane, sample id, bounce base, seed).  Each
    decision draws from stream (pixel, sample, bounce*STREAM_STRIDE +
    stream, seed)."""

    __slots__ = ("pixel", "sample", "bounce", "seed")

    def __init__(self, pixel, sample, bounce, seed):
        self.pixel = pixel
        self.sample = sample
        self.bounce = bounce
        self.seed = seed

    def uniform4(self, stream):
        return uniform4(
            self.pixel, self.sample,
            (as_u32(self.bounce) * STREAM_STRIDE + stream) & _M32,
            self.seed,
        )

    def uniform(self, stream):
        return self.uniform4(stream)[0]

    def gaussian3(self, stream):
        return _box_muller3(*self.uniform4(stream))
