"""`model:` asset import (reference: src/loaders/assimp.rs).

The reference binds Assimp (russimp) to import arbitrary model formats with
cameras, transforms and PBR materials.  Assimp is not available in this
environment, so this module implements the same *pipeline* for the formats
we can parse natively:

  * .gltf / .glb — full import via utils/gltf.py: node transforms,
    cameras, PBR materials (baseColor / roughness factors + textures),
    emissive materials with invisible proxy light spheres
  * .fbx — binary FBX via utils/fbx.py (same assembly path)
  * .dae — COLLADA via utils/collada.py (same assembly path)
  * .obj — meshes via the OBJ parser (materials default to Glossy like
    assimp.rs:144-151's fallback; no cameras in OBJ)

Matching assimp.rs semantics:
  * node transforms bake into mesh vertices (the reference wraps each node
    in a Transform, assimp.rs:84-91 — identical hit parameterization)
  * camera import: first camera wins; focal length 18/tan(hfov/2)
    (35mm-equivalent horizontal frame, assimp.rs:41-50)
  * emissive materials → Emissive(constant emission), all else → Glossy
    with ior 1.5, roughness from factor or texture channel 0
    (assimp.rs:133-178)
  * emissive meshes get an invisible proxy sphere added to the lights
    list for importance sampling; center = accumulated node translation,
    radius = min vertex distance from mesh-local origin (assimp.rs:123-129)

The port's copy of rust_raytracer_tpu/utils/model_import.py, held equal to it by
tests/test_torch_cli.py (both packages compile what it loads to equal
tables).
"""
from __future__ import annotations

import math
import os

import numpy as np

from ..scene import graph as g
from . import assets


def _gltf_material(m, importer_cache):
    """Map a GltfMaterial to (graph.Material, is_emissive), matching
    assimp.rs:133-178."""
    key = id(m)
    if key in importer_cache:
        return importer_cache[key]

    if any(v > 0.0 for v in m.emissive):
        mat = g.Emissive(g.Constant(tuple(m.emissive)))
        out = (mat, True)
    else:
        if m.base_color_image is not None:
            albedo = g.Image(pixels=m.base_color_image)
        else:
            albedo = g.Constant(tuple(m.base_color))
        if m.roughness_image is not None:
            rough = g.Channel(g.Image(pixels=m.roughness_image), 0)
        else:
            rough = g.Constant(float(m.roughness))
        normal_map = (
            g.Image(pixels=m.normal_image)
            if m.normal_image is not None else None
        )
        out = (g.Glossy(albedo, rough, 1.5, normal_map=normal_map), False)
    importer_cache[key] = out
    return out


def _load_gltf(path: str) -> g.SceneDef:
    from . import gltf

    return _assemble_instances(gltf.load(path))


def _load_dae(path: str) -> g.SceneDef:
    """COLLADA import through utils/collada.py — same GltfScene
    structure, same assembly rules as glTF (assimp.rs:71-178)."""
    from . import collada

    return _assemble_instances(collada.load(path))


def _assemble_instances(gs) -> g.SceneDef:
    """GltfScene (from the glTF or COLLADA parser) -> SceneDef: bake node
    transforms, map materials, add proxy light spheres for emissive
    meshes, first camera wins."""
    default_mat = g.Glossy(g.Constant((0.5, 0.5, 0.5)), g.Constant(0.0), 1.5)

    objects = []
    lights = []
    mat_cache = {}
    for prim, world_m, tpos in gs.instances:
        if prim.material >= 0:
            mat, emissive = _gltf_material(gs.materials[prim.material],
                                           mat_cache)
        else:
            mat, emissive = default_mat, False

        nt = prim.indices.shape[0]
        if nt == 0:
            continue
        tris = np.empty((nt, 3, 3), np.int64)
        tris[:, :, 0] = prim.indices
        tris[:, :, 1] = prim.indices if prim.normals is not None else 0
        tris[:, :, 2] = prim.indices if prim.uvs is not None else -1
        # bake the node transform into vertices/normals (exact, incl. the
        # sheared cases the reference handles by per-ray transforms)
        verts = prim.positions.astype(np.float64) @ world_m[:3, :3].T
        verts += world_m[:3, 3]
        if prim.normals is not None:
            # normals transform by the inverse-transpose
            nmat = np.linalg.inv(world_m[:3, :3]).T
            normals = prim.normals.astype(np.float64) @ nmat.T
            normals /= np.maximum(
                np.linalg.norm(normals, axis=-1, keepdims=True), 1e-30
            )
        else:
            normals = np.zeros((0, 3))
        uvs = (
            prim.uvs.astype(np.float64)
            if prim.uvs is not None else np.zeros((0, 2))
        )
        objects.append(g.Mesh(
            vertices=verts, normals=normals, uvs=uvs,
            triangles=tris, material=mat,
            flat_shading=prim.normals is None,
        ))
        if emissive:
            # invisible proxy sampling sphere (assimp.rs:123-129): center
            # at the accumulated node translation, radius = min vertex
            # distance from the mesh-local origin — scaled into world
            # units by the node transform (uniform-equivalent factor), or
            # a cm-unit FBX/scaled node shrinks the NEE cone ~100x
            r = float(np.min(np.linalg.norm(prim.positions, axis=-1)))
            r *= float(np.cbrt(abs(np.linalg.det(world_m[:3, :3]))))
            lights.append(g.ProxySphereLight(center=tuple(tpos), radius=r))

    config = _camera_config(gs.camera) if gs.camera is not None else {}
    return g.SceneDef(world=g.Group(objects), lights=lights, config=config)


def _camera_config(cam) -> dict:
    """GltfCamera -> scene config (hfov from yfov + aspect; focal =
    18/tan(hfov/2), the 35mm-equivalent conversion of assimp.rs:49)."""
    aspect = cam.aspect if cam.aspect else 1.5
    hfov = 2.0 * math.atan(math.tan(cam.yfov / 2.0) * aspect)
    return {
        "camera_pos": tuple(float(v) for v in cam.position),
        "camera_target": tuple(float(v) for v in cam.look_at),
        "aspect_ratio": float(aspect),
        "focal_length": 18.0 / math.tan(hfov / 2.0),
    }


def _load_fbx(path: str) -> g.SceneDef:
    """FBX import through utils/fbx.py — same assembly rules as glTF
    (matching assimp.rs:71-178): bake node transforms, map materials,
    proxy light spheres for emissive meshes, first camera wins."""
    from . import fbx

    fs = fbx.load(path)
    default_mat = g.Glossy(g.Constant((0.5, 0.5, 0.5)), g.Constant(0.0), 1.5)

    objects = []
    lights = []
    mat_cache = {}
    for m in fs.meshes:
        prim = m.primitive
        if prim.material >= 0:
            mat, emissive = _gltf_material(fs.materials[prim.material],
                                           mat_cache)
        else:
            mat, emissive = default_mat, False
        world_m = m.world
        verts = prim.positions.astype(np.float64) @ world_m[:3, :3].T
        verts += world_m[:3, 3]
        if prim.normals is not None and prim.normals.shape[0]:
            nmat = np.linalg.inv(world_m[:3, :3]).T
            normals = prim.normals.astype(np.float64) @ nmat.T
            normals /= np.maximum(
                np.linalg.norm(normals, axis=-1, keepdims=True), 1e-30
            )
        else:
            normals = np.zeros((0, 3))
        uvs = (
            prim.uvs.astype(np.float64)
            if prim.uvs is not None else np.zeros((0, 2))
        )
        objects.append(g.Mesh(
            vertices=verts, normals=normals, uvs=uvs,
            triangles=m.tris, material=mat,
            flat_shading=normals.shape[0] == 0,
        ))
        if emissive:
            r = float(np.min(np.linalg.norm(prim.positions, axis=-1)))
            r *= float(np.cbrt(abs(np.linalg.det(world_m[:3, :3]))))
            lights.append(g.ProxySphereLight(
                center=tuple(m.translation), radius=r))

    config = _camera_config(fs.camera) if fs.camera is not None else {}
    return g.SceneDef(world=g.Group(objects), lights=lights, config=config)


def load_model(path: str) -> g.SceneDef:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".gltf", ".glb"):
        return _load_gltf(path)
    if ext == ".fbx":
        return _load_fbx(path)
    if ext == ".dae":
        return _load_dae(path)
    if ext == ".obj":
        mat = g.Glossy(
            g.Constant((0.8, 0.8, 0.8)), g.Constant(0.5), 1.5
        )  # assimp.rs default-ish PBR fallback
        mesh = assets.load_obj(path, mat)
        sky = g.Sky(g.Constant((1.0, 1.0, 1.0)))
        world = g.Group([mesh, sky])
        return g.SceneDef(world=world, lights=[sky], config={})
    raise NotImplementedError(
        f"model import for '{ext}' is unsupported; "
        "supported: .gltf, .glb, .fbx, .dae, .obj"
    )
