"""Minimal COLLADA (.dae) importer.

Widens the `model:` loader's Assimp-format breadth (reference:
src/loaders/assimp.rs:29-35 imports any Assimp-readable format; COLLADA
is the most common plain-XML one).  Parses the 1.4/1.5 schema subset the
render pipeline needs and returns the same `GltfScene` structure as
utils/gltf.py, so utils/model_import.py shares one scene-assembly path
for glTF, FBX and COLLADA:

  * Geometry: <source>/<float_array> + <vertices>, <triangles> and
    <polylist> (fan triangulation) with per-input index offsets
    (VERTEX / NORMAL / TEXCOORD); multi-index corners are expanded to
    per-corner vertices.
  * Scene graph: <node> trees with <matrix>, <translate>,
    <rotate> (axis-angle, degrees) and <scale>, composed top-down;
    <instance_geometry> material binding via <instance_material>.
  * Materials: profile_COMMON lambert/phong/blinn — diffuse and
    emission <color>, <shininess> mapped to perceptual roughness
    exactly like the FBX importer (sqrt(2/(exponent+2))).
  * Camera: <perspective> xfov/yfov (degrees) + aspect_ratio, placed by
    its node's world matrix (position = origin, look direction = -Z,
    the COLLADA camera convention).
  * <up_axis> Z_UP / X_UP are converted to the renderer's Y-up world.

Subset limits: no controllers/skinning, no <lines>/<polygons> with
holes, no texture file references (constant colors only — the DSL or
glTF path covers textured assets).

The port's copy of rust_raytracer_tpu/utils/collada.py, held equal to it by
tests/test_torch_cli.py (both packages compile what it loads to equal
tables).
"""
from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from .gltf import GltfCamera, GltfMaterial, GltfPrimitive, GltfScene


def _tag(e) -> str:
    return e.tag.split("}")[-1]


def _children(e, name: str):
    return [c for c in e if _tag(c) == name]


def _child(e, name: str):
    cs = _children(e, name)
    return cs[0] if cs else None


def _floats(text: str) -> np.ndarray:
    return np.array([float(t) for t in text.split()], np.float64)


def _ints(text: str) -> np.ndarray:
    return np.array([int(t) for t in text.split()], np.int64)


def _find_all_deep(root, name: str):
    return [e for e in root.iter() if _tag(e) == name]


_UP_FIX = {
    # world is Y-up, -Z forward (glTF convention shared by the assembly)
    "Y_UP": np.eye(4),
    "Z_UP": np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0],
                      [0, 0, 0, 1]], np.float64),
    "X_UP": np.array([[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0],
                      [0, 0, 0, 1]], np.float64),
}


def _node_matrix(node) -> np.ndarray:
    """Compose a node's local transform elements in document order
    (COLLADA 1.4 §3.5: transforms apply in the order written)."""
    m = np.eye(4)
    for c in node:
        t = _tag(c)
        if t == "matrix":
            v = _floats(c.text)
            m = m @ v.reshape(4, 4)  # row-major in the document
        elif t == "translate":
            v = _floats(c.text)
            tm = np.eye(4)
            tm[:3, 3] = v[:3]
            m = m @ tm
        elif t == "rotate":
            v = _floats(c.text)
            axis = v[:3]
            n = np.linalg.norm(axis)
            if n > 0:
                axis = axis / n
                a = math.radians(v[3])
                x, y, z = axis
                c_, s = math.cos(a), math.sin(a)
                C = 1 - c_
                rm = np.eye(4)
                rm[:3, :3] = [
                    [x * x * C + c_, x * y * C - z * s, x * z * C + y * s],
                    [y * x * C + z * s, y * y * C + c_, y * z * C - x * s],
                    [z * x * C - y * s, z * y * C + x * s, z * z * C + c_],
                ]
                m = m @ rm
        elif t == "scale":
            v = _floats(c.text)
            sm = np.diag([v[0], v[1], v[2], 1.0])
            m = m @ sm
    return m


def _parse_effect(eff) -> GltfMaterial:
    mat = GltfMaterial(name=eff.get("id", ""))
    for shader in ("lambert", "phong", "blinn", "constant"):
        for sh in _find_all_deep(eff, shader):
            dif = _child(sh, "diffuse")
            if dif is not None:
                col = _child(dif, "color")
                if col is not None:
                    v = _floats(col.text)
                    mat.base_color = (v[0], v[1], v[2])
            emi = _child(sh, "emission")
            if emi is not None:
                col = _child(emi, "color")
                if col is not None:
                    v = _floats(col.text)
                    mat.emissive = (v[0], v[1], v[2])
            shi = _child(sh, "shininess")
            if shi is not None:
                fl = _child(shi, "float")
                if fl is not None:
                    exp = float(fl.text)
                    # Blinn-Phong exponent -> perceptual roughness,
                    # matching utils/fbx.py / assimp's fallback
                    mat.roughness = float(np.clip(
                        math.sqrt(2.0 / (exp + 2.0)), 0.0, 1.0))
            if shader == "lambert":
                mat.roughness = 1.0
    return mat


def _parse_mesh(mesh_el, sources: Dict[str, np.ndarray],
                mat_index: Dict[str, int]) -> List[GltfPrimitive]:
    """One <mesh> -> GltfPrimitives (per <triangles>/<polylist> block),
    corners expanded (positions/normals/uvs all (3T, ...) with
    indices = arange)."""
    # vertices indirection: <vertices id> POSITION -> source
    vert_src: Dict[str, np.ndarray] = {}
    for v in _children(mesh_el, "vertices"):
        for inp in _children(v, "input"):
            if inp.get("semantic") == "POSITION":
                vert_src[v.get("id")] = sources[inp.get("source").lstrip("#")]

    prims = []
    for block in list(_children(mesh_el, "triangles")
                      ) + list(_children(mesh_el, "polylist")):
        inputs = []   # (offset, semantic, array)
        max_off = 0
        for inp in _children(block, "input"):
            off = int(inp.get("offset", "0"))
            sem = inp.get("semantic")
            src_id = inp.get("source").lstrip("#")
            arr = vert_src.get(src_id, sources.get(src_id))
            if arr is None:
                continue
            inputs.append((off, sem, arr))
            max_off = max(max_off, off)
        stride = max_off + 1
        p_el = _child(block, "p")
        if p_el is None:
            continue
        p = _ints(p_el.text).reshape(-1, stride)

        if _tag(block) == "polylist":
            vcount = _ints(_child(block, "vcount").text)
            corners = []
            base = 0
            for n in vcount:       # fan-triangulate each polygon
                for k in range(1, int(n) - 1):
                    corners += [base, base + k, base + k + 1]
                base += int(n)
            p = p[np.array(corners, np.int64)]
        nt = p.shape[0] // 3

        pos = nrm = uv = None
        for off, sem, arr in inputs:
            idx = p[:, off]
            if sem == "VERTEX" or sem == "POSITION":
                pos = arr.reshape(-1, 3)[idx].astype(np.float32)
            elif sem == "NORMAL":
                nrm = arr.reshape(-1, 3)[idx].astype(np.float32)
            elif sem == "TEXCOORD":
                uv = arr.reshape(-1, 2)[idx].astype(np.float32)
        if pos is None or nt == 0:
            continue
        mat_sym = block.get("material", "")
        prims.append(GltfPrimitive(
            positions=pos, normals=nrm, uvs=uv,
            indices=np.arange(3 * nt, dtype=np.int64).reshape(nt, 3),
            material=mat_index.get(mat_sym, -1),
        ))
    return prims


def load(path: str) -> GltfScene:
    root = ET.parse(path).getroot()
    up = np.eye(4)
    asset = _child(root, "asset")
    if asset is not None:
        ua = _child(asset, "up_axis")
        if ua is not None and ua.text:
            up = _UP_FIX.get(ua.text.strip(), np.eye(4))

    # sources: float_array id -> values (accessor strides handled at use)
    sources: Dict[str, np.ndarray] = {}
    for src in _find_all_deep(root, "source"):
        fa = _child(src, "float_array")
        if fa is not None and fa.text:
            sources[src.get("id")] = _floats(fa.text)

    # materials: material id -> effect; effects parsed to GltfMaterial
    effects = {e.get("id"): _parse_effect(e)
               for e in _find_all_deep(root, "effect")}
    materials: List[GltfMaterial] = []
    mat_ids: Dict[str, int] = {}
    for m in _find_all_deep(root, "material"):
        if _tag(m) != "material" or m.get("id") is None:
            continue
        ie = _child(m, "instance_effect")
        eff = effects.get(ie.get("url").lstrip("#")) if ie is not None \
            else GltfMaterial()
        mat_ids[m.get("id")] = len(materials)
        materials.append(eff or GltfMaterial())

    # geometries: id -> list of primitive factories (material symbol
    # binding is resolved per instance below)
    geoms: Dict[str, ET.Element] = {
        g.get("id"): g for g in _find_all_deep(root, "geometry")}

    cameras: Dict[str, ET.Element] = {
        c.get("id"): c for c in _find_all_deep(root, "camera")
        if _tag(c) == "camera"}

    scene = GltfScene(materials=materials)

    def walk(node, parent_m):
        world = parent_m @ _node_matrix(node)
        for ig in _children(node, "instance_geometry"):
            gid = ig.get("url", "").lstrip("#")
            gel = geoms.get(gid)
            if gel is None:
                continue
            # material symbol -> material id for this instance
            sym_map: Dict[str, int] = {}
            for im in _find_all_deep(ig, "instance_material"):
                tgt = im.get("target", "").lstrip("#")
                if tgt in mat_ids:
                    sym_map[im.get("symbol", "")] = mat_ids[tgt]
            mesh_el = _child(gel, "mesh")
            if mesh_el is None:
                continue
            for prim in _parse_mesh(mesh_el, sources, sym_map):
                scene.instances.append((prim, world, world[:3, 3].copy()))
        for ic in _children(node, "instance_camera"):
            cel = cameras.get(ic.get("url", "").lstrip("#"))
            if cel is not None and scene.camera is None:
                persp = _find_all_deep(cel, "perspective")
                if persp:
                    yfov = xfov = None
                    aspect = None
                    for e in persp[0]:
                        t = _tag(e)
                        if t == "yfov":
                            yfov = math.radians(float(e.text))
                        elif t == "xfov":
                            xfov = math.radians(float(e.text))
                        elif t == "aspect_ratio":
                            aspect = float(e.text)
                    if yfov is None and xfov is not None:
                        a = aspect or 1.5
                        yfov = 2.0 * math.atan(math.tan(xfov / 2.0) / a)
                    if yfov is not None:
                        pos = world[:3, 3]
                        fwd = -world[:3, 2]  # COLLADA camera looks -Z
                        scene.camera = GltfCamera(
                            position=pos, look_at=pos + fwd,
                            yfov=yfov, aspect=aspect)
        for child in _children(node, "node"):
            walk(child, world)

    for vs in _find_all_deep(root, "visual_scene"):
        for node in _children(vs, "node"):
            walk(node, up)
    return scene
