"""Procedural meshes of the benchmark's plain reference.

A frozen copy of the same-named plain module of rust_raytracer_torch, kept
here so the reference imports nothing of the program it judges.  Do not
change it to follow the program: a change of the program's arithmetic is
what the comparison exists to catch.

The reference's cornell_dragon benchmark uses an 870k-tri Stanford dragon
OBJ that is stripped from the mounted repo (.MISSING_LARGE_BLOBS).  For
benchmarking at the same scale we synthesize a deterministic torus-knot
tube with a matched triangle count — comparable BVH depth and incoherent
secondary-ray behavior.
"""
from __future__ import annotations

import numpy as np

from . import graph


def torus_knot_mesh(
    material,
    rings: int = 933,
    segments: int = 466,
    p: int = 2,
    q: int = 3,
    tube_radius: float = 0.35,
    knot_radius: float = 1.0,
) -> graph.Mesh:
    """Closed (p, q) torus-knot tube: rings*segments vertices,
    2*rings*segments triangles (defaults: 869,556 tris ~ dragon scale)."""
    t = np.linspace(0, 2 * np.pi, rings, endpoint=False)

    r = knot_radius * (2 + np.cos(q * t)) / 3.0
    center = np.stack(
        [r * np.cos(p * t), r * np.sin(p * t), knot_radius * np.sin(q * t) / 3.0],
        axis=-1,
    )

    # Frenet-ish frame via finite differences
    tangent = np.roll(center, -1, 0) - np.roll(center, 1, 0)
    tangent /= np.linalg.norm(tangent, axis=-1, keepdims=True)
    ref = np.array([0.0, 0.0, 1.0])
    side = np.cross(tangent, ref)
    bad = np.linalg.norm(side, axis=-1) < 1e-6
    side[bad] = np.cross(tangent[bad], np.array([1.0, 0.0, 0.0]))
    side /= np.linalg.norm(side, axis=-1, keepdims=True)
    up = np.cross(tangent, side)

    phi = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    # slight radius modulation to break symmetry (more dragon-like AABBs)
    rr = tube_radius * (1.0 + 0.25 * np.sin(3 * t))[:, None]
    ring_pts = (
        center[:, None, :]
        + (np.cos(phi)[None, :, None] * side[:, None, :]
           + np.sin(phi)[None, :, None] * up[:, None, :]) * rr[:, :, None]
    )  # (rings, segments, 3)
    normals = (ring_pts - center[:, None, :])
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)

    verts = ring_pts.reshape(-1, 3)
    nrms = normals.reshape(-1, 3)

    i = np.arange(rings)[:, None]
    j = np.arange(segments)[None, :]
    v00 = (i * segments + j).ravel()
    v01 = (i * segments + (j + 1) % segments).ravel()
    v10 = (((i + 1) % rings) * segments + j).ravel()
    v11 = (((i + 1) % rings) * segments + (j + 1) % segments).ravel()

    tri_a = np.stack([v00, v10, v01], axis=-1)
    tri_b = np.stack([v01, v10, v11], axis=-1)
    vidx = np.concatenate([tri_a, tri_b], axis=0).astype(np.int32)

    tris = np.stack([vidx, vidx, np.full_like(vidx, -1)], axis=-1)
    return graph.Mesh(
        vertices=verts,
        normals=nrms,
        uvs=np.zeros((0, 2)),
        triangles=tris,
        material=material,
    )
