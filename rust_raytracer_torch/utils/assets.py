"""Asset loading: OBJ meshes (reference: src/loaders/obj.rs).

Supports the same subset as the reference parser: `v`, `vt`, `vn`, `f` with
`v/vt/vn` triples, missing `vt` (`v//vn`), and negative (relative) indices.
Faces are assumed triangulated (the reference indexes exactly 3 corners).
A fast C++ parser (native/) can replace the hot path for huge meshes; this
NumPy version handles Suzanne-class meshes in milliseconds.

The port's copy of rust_raytracer_tpu/utils/assets.py, held equal to it by
tests/test_torch_scene.py (both packages compile the same scenes to equal
tables).
"""
from __future__ import annotations

import numpy as np

from ..scene import graph
from . import log


def load_obj(path: str, material, flat_shading: bool = False,
             hit_back_faces: bool = False) -> graph.Mesh:
    verts, uvs, normals, tris = parse_obj(path)
    log.info(f"Loaded {len(tris)} tris")
    return graph.Mesh(
        vertices=verts,
        normals=normals,
        uvs=uvs,
        triangles=tris,
        material=material,
        flat_shading=flat_shading,
        hit_back_faces=hit_back_faces,
    )


def parse_obj(path: str):
    """Parse an OBJ file into (verts(V,3), uvs(U,2), normals(N,3),
    tris(T,3,3) int32 of (vert, normal, uv) indices, uv=-1 if absent).

    Uses the native C++ parser (native/obj.cc) when available; this NumPy
    path is the fallback and the behavioral reference for tests."""
    from .. import native

    parsed = native.parse_obj(path) if native.available() else None
    if parsed is not None:
        verts, uvs, normals, tris = parsed
        return verts, uvs, normals, tris

    verts = []
    uvs = []
    normals = []
    tris = []

    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            cmd = parts[0]
            if cmd == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif cmd == "vt":
                vals = [float(x) for x in parts[1:]]
                uvs.append(vals[:2])
            elif cmd == "vn":
                n = np.array([float(x) for x in parts[1:4]])
                n /= max(np.linalg.norm(n), 1e-30)
                normals.append(n)
            elif cmd == "f":
                corners = []
                for p in parts[1:]:
                    comps = p.split("/")
                    vi = int(comps[0])
                    vi = vi - 1 if vi > 0 else len(verts) + vi
                    ti = -1
                    if len(comps) > 1 and comps[1] != "":
                        t = int(comps[1])
                        ti = t - 1 if t > 0 else len(uvs) + t
                    ni = 0
                    if len(comps) > 2 and comps[2] != "":
                        nn = int(comps[2])
                        ni = nn - 1 if nn > 0 else len(normals) + nn
                    corners.append((vi, ni, ti))
                # a polygon is fan-triangulated, as native/obj.cc and the
                # reference's loader do; a triangle "has uvs" only if all
                # three corners do (obj.rs:83-91)
                for k in range(1, len(corners) - 1):
                    tri = [corners[0], corners[k], corners[k + 1]]
                    if any(c[2] < 0 for c in tri):
                        tri = [(v, n, -1) for v, n, _ in tri]
                    tris.append(tri)

    return (
        np.asarray(verts, np.float64).reshape(-1, 3),
        np.asarray(uvs, np.float64).reshape(-1, 2),
        np.asarray(normals, np.float64).reshape(-1, 3),
        np.asarray(tris, np.int32).reshape(-1, 3, 3),
    )
