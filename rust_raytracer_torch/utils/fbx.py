"""Minimal FBX 7.x binary importer.

Closes the Assimp-breadth gap of the `model:` loader (reference:
src/loaders/assimp.rs:29-35 imports any Assimp-readable format; FBX is
the one format the reference ships a sample of, models/test.fbx).  This
is a from-scratch reader of the public FBX binary container — node
records, typed properties, zlib-deflated arrays — plus the subset of the
document semantics the render pipeline needs:

  * Geometry: Vertices / PolygonVertexIndex (fan triangulation),
    LayerElementNormal and LayerElementUV in the ByPolygonVertex /
    ByVertice x Direct / IndexToDirect mapping combinations
  * Model nodes: Lcl Translation / Rotation (euler, all 6 orders) /
    Scaling, PreRotation, GeometricTranslation/Rotation/Scaling,
    composed through the Connections (OO) tree from the root
  * Materials: DiffuseColor, EmissiveColor x EmissiveFactor, Shininess
    (mapped to roughness like assimp's shininess->roughness fallback)
  * Cameras: NodeAttribute Position / InterestPosition / FieldOfView
    (horizontal degrees), transformed by the camera model's node matrix

Returns the same `GltfScene` structure as utils/gltf.py, so
utils/model_import.py shares one scene-assembly path for glTF and FBX.

Known subset limits (validated against Blender-exported files — the
reference's own models/test.fbx is one):

  * The camera NodeAttribute `Position` is read as WORLD-space (Blender
    writes it that way); the FBX spec makes it local to the camera
    model node, so other exporters can misplace the camera.  Prefer
    re-exporting with a baked camera or overriding via CLI flags.
  * GlobalSettings unit/axis conversion is not applied (Blender's
    default export already bakes it).
  * Only OO (object-object) connections are walked; OP property links
    (e.g. file-texture bindings) are ignored — materials import their
    constant colors only.
  * LayerElementMaterial is ignored: a multi-material mesh gets its
    FIRST material for every polygon.

The port's copy of rust_raytracer_tpu/utils/fbx.py, held equal to it by
tests/test_torch_cli.py (both packages compile what it loads to equal
tables).
"""
from __future__ import annotations

import math
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .gltf import GltfCamera, GltfMaterial, GltfPrimitive, GltfScene

_MAGIC = b"Kaydara FBX Binary  \x00"
_ARRAY_ITEM = {"f": ("<f", 4), "d": ("<d", 8), "l": ("<q", 8),
               "i": ("<i", 4), "b": ("<b", 1)}
_ARRAY_NP = {"f": np.float32, "d": np.float64, "l": np.int64,
             "i": np.int32, "b": np.int8}


@dataclass
class _Node:
    name: str
    props: List
    children: List["_Node"] = field(default_factory=list)

    def find(self, name: str) -> Optional["_Node"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["_Node"]:
        return [c for c in self.children if c.name == name]

    def prop70(self) -> Dict[str, List]:
        """Properties70 -> {prop name: [values after the 4 header strings]}."""
        out = {}
        p70 = self.find("Properties70")
        if p70 is None:
            return out
        for p in p70.find_all("P"):
            if p.props:
                out[p.props[0]] = p.props[4:]
        return out


def _parse_props(data: bytes, pos: int, count: int) -> Tuple[List, int]:
    props = []
    for _ in range(count):
        tc = chr(data[pos])
        pos += 1
        if tc == "Y":
            props.append(struct.unpack_from("<h", data, pos)[0]); pos += 2
        elif tc == "C":
            props.append(bool(data[pos])); pos += 1
        elif tc == "I":
            props.append(struct.unpack_from("<i", data, pos)[0]); pos += 4
        elif tc == "F":
            props.append(struct.unpack_from("<f", data, pos)[0]); pos += 4
        elif tc == "D":
            props.append(struct.unpack_from("<d", data, pos)[0]); pos += 8
        elif tc == "L":
            props.append(struct.unpack_from("<q", data, pos)[0]); pos += 8
        elif tc in _ARRAY_ITEM:
            n, enc, nbytes = struct.unpack_from("<III", data, pos)
            pos += 12
            _, isz = _ARRAY_ITEM[tc]
            if enc:
                raw = zlib.decompress(data[pos:pos + nbytes])
                pos += nbytes
            else:
                raw = data[pos:pos + n * isz]
                pos += n * isz
            props.append(np.frombuffer(raw, dtype=_ARRAY_NP[tc], count=n))
        elif tc == "S":
            n = struct.unpack_from("<I", data, pos)[0]; pos += 4
            props.append(data[pos:pos + n].decode("utf-8", "replace"))
            pos += n
        elif tc == "R":
            n = struct.unpack_from("<I", data, pos)[0]; pos += 4
            props.append(data[pos:pos + n]); pos += n
        else:
            raise ValueError(f"FBX: unknown property type {tc!r} at {pos}")
    return props, pos


def _parse_children(data: bytes, pos: int, end: int, big: bool,
                    out: List[_Node]):
    while pos < end:
        child, pos = _parse_node(data, pos, big)
        if child is None:
            break
        out.append(child)
    return pos


def _parse_node(data: bytes, pos: int, big: bool):
    """One node record; returns (node | None, next_pos).  None = NULL
    terminator record."""
    if big:
        end, nprops, _plen = struct.unpack_from("<QQQ", data, pos)
        pos += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", data, pos)
        pos += 12
    nlen = data[pos]
    pos += 1
    name = data[pos:pos + nlen].decode("latin1")
    pos += nlen
    if end == 0 and not name:
        return None, pos
    props, pos = _parse_props(data, pos, nprops)
    node = _Node(name, props)
    if pos < end:
        pos = _parse_children(data, pos, end, big, node.children)
    return node, max(pos, end)


def parse(data: bytes) -> _Node:
    """Parse an FBX binary blob into a root _Node tree."""
    if not data.startswith(_MAGIC):
        raise ValueError("not an FBX binary file")
    version = struct.unpack_from("<I", data, 23)[0]
    big = version >= 7500
    root = _Node("", [])
    pos = 27
    sentinel = 25 + 1 if big else 13  # null record size (incl. name byte 0)
    while pos + sentinel <= len(data):
        node, pos = _parse_node(data, pos, big)
        if node is None:
            break
        root.children.append(node)
    return root


# ---------------------------------------------------------------------------
# Document semantics
# ---------------------------------------------------------------------------


def _euler_deg(v, order_code: int) -> np.ndarray:
    """FBX euler (degrees, rotation order code) -> 3x3 rotation matrix.
    Order code e: 0=XYZ ... applied leftmost-first (XYZ: X first)."""
    rx, ry, rz = (math.radians(float(a)) for a in v[:3])
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    X = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    orders = {0: "XYZ", 1: "XZY", 2: "YZX", 3: "YXZ", 4: "ZXY", 5: "ZYX"}
    mats = {"X": X, "Y": Y, "Z": Z}
    m = np.eye(3)
    for axis in orders.get(order_code, "XYZ"):
        m = mats[axis] @ m  # leftmost of the order string applies first
    return m


def _affine(r: np.ndarray, t, s) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = r * np.asarray(s, np.float64)[None, :]
    m[:3, 3] = t
    return m


def _vec3(props: Dict[str, List], key: str, default=(0.0, 0.0, 0.0)):
    v = props.get(key)
    if not v or len(v) < 3:
        return np.array(default, np.float64)
    return np.array([float(v[0]), float(v[1]), float(v[2])], np.float64)


def _model_matrix(props: Dict[str, List]) -> np.ndarray:
    """Local node transform: T * PreR * R * S (the common subset of the
    full FBX pivot formula; pivots/offsets default to zero)."""
    t = _vec3(props, "Lcl Translation")
    s = _vec3(props, "Lcl Scaling", (1.0, 1.0, 1.0))
    order = int(props.get("RotationOrder", [0])[0]) if props.get(
        "RotationOrder") else 0
    r = _euler_deg(_vec3(props, "Lcl Rotation"), order)
    if "PreRotation" in props:
        r = _euler_deg(_vec3(props, "PreRotation"), 0) @ r
    return _affine(r, t, s)


def _geometric_matrix(props: Dict[str, List]) -> Optional[np.ndarray]:
    if not any(k.startswith("Geometric") for k in props):
        return None
    t = _vec3(props, "GeometricTranslation")
    s = _vec3(props, "GeometricScaling", (1.0, 1.0, 1.0))
    r = _euler_deg(_vec3(props, "GeometricRotation"), 0)
    return _affine(r, t, s)


def _layer_values(geom: _Node, layer_name: str, value_name: str,
                  index_name: str, n_corners: int, n_verts: int,
                  poly_of_corner: np.ndarray, width: int):
    """Resolve a layer element to per-CORNER values (n_corners, width), or
    None if the layer is absent."""
    layer = geom.find(layer_name)
    if layer is None:
        return None
    vals_node = layer.find(value_name)
    if vals_node is None or not len(vals_node.props):
        return None
    vals = np.asarray(vals_node.props[0], np.float64).reshape(-1, width)
    mapping = (layer.find("MappingInformationType") or _Node("", ["?"])
               ).props[0]
    ref = (layer.find("ReferenceInformationType") or _Node("", ["Direct"])
           ).props[0]
    idx = None
    if ref == "IndexToDirect" or ref == "Index":
        idx_node = layer.find(index_name)
        if idx_node is not None and len(idx_node.props):
            idx = np.asarray(idx_node.props[0], np.int64)
    if mapping == "ByPolygonVertex":
        per = vals[idx] if idx is not None else vals
        return per[:n_corners]
    if mapping in ("ByVertice", "ByVertex"):
        per_v = vals[idx] if idx is not None else vals
        return None, per_v  # caller maps via vertex index
    if mapping == "ByPolygon":
        per_p = vals[idx] if idx is not None else vals
        return per_p[poly_of_corner]
    if mapping == "AllSame":
        one = vals[idx[0]] if idx is not None and len(idx) else vals[0]
        return np.broadcast_to(one, (n_corners, width)).copy()
    return None


def _triangulate(geom: _Node) -> Optional[dict]:
    vtx = geom.find("Vertices")
    pvi = geom.find("PolygonVertexIndex")
    if vtx is None or pvi is None:
        return None
    verts = np.asarray(vtx.props[0], np.float64).reshape(-1, 3)
    raw = np.asarray(pvi.props[0], np.int64)
    n_corners = raw.shape[0]
    vidx = np.where(raw < 0, ~raw, raw)
    poly_end = raw < 0
    poly_id = np.concatenate([[0], np.cumsum(poly_end)[:-1]])
    # fan-triangulate: for each polygon with corners c0..ck, emit
    # (c0, c_i, c_i+1).  Build with numpy over the corner array.
    starts = np.concatenate([[0], np.nonzero(poly_end)[0][:-1] + 1])
    counts = np.diff(np.concatenate([starts, [n_corners]]))
    tri_counts = np.maximum(counts - 2, 0)
    n_tris = int(tri_counts.sum())
    if n_tris == 0:
        return None
    tri_poly = np.repeat(np.arange(len(starts)), tri_counts)
    # index of the triangle within its polygon
    base = np.concatenate([[0], np.cumsum(tri_counts)[:-1]])
    within = np.arange(n_tris) - base[tri_poly]
    c0 = starts[tri_poly]
    c1 = c0 + within + 1
    c2 = c0 + within + 2
    corners = np.stack([c0, c1, c2], axis=1)  # (T, 3) corner indices
    return dict(verts=verts, vidx=vidx, corners=corners,
                n_corners=n_corners, poly_of_corner=poly_id)


def _geometry_to_primitive(geom: _Node, material: int) -> Optional[
        Tuple[GltfPrimitive, np.ndarray]]:
    """Returns (primitive, corner-index triples (T,3,3)) in the graph.Mesh
    index convention: per corner [vertex_idx, normal_idx, uv_idx]."""
    tri = _triangulate(geom)
    if tri is None:
        return None
    verts, vidx, corners = tri["verts"], tri["vidx"], tri["corners"]
    n_corners, poly_of_corner = tri["n_corners"], tri["poly_of_corner"]

    def resolve(layer, value, index, width):
        r = _layer_values(geom, layer, value, index, n_corners, len(verts),
                          poly_of_corner, width)
        if isinstance(r, tuple):  # per-vertex values
            return r[1], "vertex"
        return r, "corner"

    normals, nmode = resolve("LayerElementNormal", "Normals", "NormalsIndex",
                             3)
    uvs, umode = resolve("LayerElementUV", "UV", "UVIndex", 2)

    tris = np.empty((corners.shape[0], 3, 3), np.int64)
    tris[:, :, 0] = vidx[corners]
    if normals is None:
        tris[:, :, 1] = 0
        norm_arr = None
    elif nmode == "vertex":
        tris[:, :, 1] = vidx[corners]
        norm_arr = normals
    else:
        tris[:, :, 1] = corners
        norm_arr = normals
    if uvs is None:
        tris[:, :, 2] = -1
        uv_arr = None
    elif umode == "vertex":
        tris[:, :, 2] = vidx[corners]
        uv_arr = uvs
    else:
        tris[:, :, 2] = corners
        uv_arr = uvs

    prim = GltfPrimitive(
        positions=verts.astype(np.float32),
        normals=None if norm_arr is None else norm_arr.astype(np.float32),
        uvs=None if uv_arr is None else uv_arr.astype(np.float32),
        indices=tris[:, :, 0],
        material=material,
    )
    return prim, tris


def _material_to_gltf(mat_node: _Node) -> GltfMaterial:
    p = mat_node.prop70()
    diffuse = tuple(_vec3(p, "DiffuseColor", (0.8, 0.8, 0.8)))
    emissive = _vec3(p, "EmissiveColor")
    ef = p.get("EmissiveFactor")
    factor = float(ef[0]) if ef else 1.0
    emissive = tuple(emissive * factor)
    shin = p.get("Shininess") or p.get("ShininessExponent")
    if shin:
        # Blinn-Phong exponent -> perceptual roughness (assimp-style)
        roughness = float(np.clip(math.sqrt(2.0 / (float(shin[0]) + 2.0)),
                                  0.0, 1.0))
    else:
        roughness = 1.0
    name = mat_node.props[1] if len(mat_node.props) > 1 else ""
    return GltfMaterial(name=str(name), base_color=diffuse,
                        roughness=roughness, emissive=emissive)


@dataclass
class FbxMesh:
    """A mesh instance with graph.Mesh-convention corner triples."""
    primitive: GltfPrimitive
    tris: np.ndarray       # (T, 3, 3) [vertex, normal, uv] corner indices
    world: np.ndarray      # (4, 4)
    translation: np.ndarray  # accumulated node translation (3,)


@dataclass
class FbxScene:
    meshes: List[FbxMesh] = field(default_factory=list)
    materials: List[GltfMaterial] = field(default_factory=list)
    camera: Optional[GltfCamera] = None


def load(path: str) -> FbxScene:
    with open(path, "rb") as f:
        root = parse(f.read())

    objects = root.find("Objects")
    conns = root.find("Connections")
    if objects is None or conns is None:
        raise ValueError("FBX: missing Objects/Connections")

    by_id: Dict[int, _Node] = {}
    for o in objects.children:
        if o.props and isinstance(o.props[0], int):
            by_id[o.props[0]] = o

    children: Dict[int, List[int]] = {}   # parent id -> [child ids] (OO)
    for c in conns.find_all("C"):
        if len(c.props) >= 3 and c.props[0] == "OO":
            children.setdefault(int(c.props[2]), []).append(int(c.props[1]))

    scene = FbxScene()
    mat_index: Dict[int, int] = {}

    def conv_material(mid: int) -> int:
        if mid not in mat_index:
            mat_index[mid] = len(scene.materials)
            scene.materials.append(_material_to_gltf(by_id[mid]))
        return mat_index[mid]

    def walk(node_id: int, parent_m: np.ndarray, parent_t: np.ndarray):
        for cid in children.get(node_id, []):
            obj = by_id.get(cid)
            if obj is None or obj.name != "Model":
                continue
            props = obj.prop70()
            local = _model_matrix(props)
            world = parent_m @ local
            tpos = parent_t + local[:3, 3]
            kids = children.get(cid, [])
            geo = _geometric_matrix(props)
            cls = obj.props[2] if len(obj.props) > 2 else ""
            if cls == "Camera":
                _camera(obj, kids, world)
            for k in kids:
                kobj = by_id.get(k)
                if kobj is None:
                    continue
                if kobj.name == "Geometry":
                    mats = [conv_material(m) for m in kids
                            if m in by_id and by_id[m].name == "Material"]
                    out = _geometry_to_primitive(
                        kobj, mats[0] if mats else -1)
                    if out is None:
                        continue
                    prim, tris = out
                    w = world if geo is None else world @ geo
                    scene.meshes.append(FbxMesh(
                        primitive=prim, tris=tris, world=w,
                        translation=tpos))
            walk(cid, world, tpos)

    def _camera(model: _Node, kids: List[int], world: np.ndarray):
        # Blender-style FBX: the camera NodeAttribute's Position /
        # InterestPosition are world-space (they duplicate the model
        # node's Lcl Translation), so they are used directly; the model
        # matrix is only the fallback when the attribute lacks them.
        attr = next((by_id[k] for k in kids
                     if k in by_id and by_id[k].name == "NodeAttribute"), None)
        p = attr.prop70() if attr is not None else {}
        position = _vec3(p, "Position") if "Position" in p else world[:3, 3]
        # FBX cameras aim along their local +X axis; the node ROTATION is
        # authoritative (Blender exports a default-valued InterestPosition
        # that ignores the camera's tilt — verified against the glb twin
        # of models/test.fbx).
        fwd = world[:3, :3] @ np.array([1.0, 0.0, 0.0])
        n = np.linalg.norm(fwd)
        fwd = fwd / n if n > 0 else np.array([0.0, 0.0, -1.0])
        look_at = position + fwd
        ar = p.get("FilmAspectRatio") or p.get("AspectRatio")
        aspect = float(ar[0]) if ar else 1.5
        fovy = p.get("FieldOfViewY")
        if fovy:
            yfov = math.radians(float(fovy[0]))
        else:
            fov = p.get("FieldOfView")
            hfov = math.radians(float(fov[0])) if fov else math.radians(40.0)
            yfov = 2.0 * math.atan(math.tan(hfov / 2.0) / aspect)
        if scene.camera is None:
            scene.camera = GltfCamera(position=position, look_at=look_at,
                                      yfov=yfov, aspect=aspect)

    walk(0, np.eye(4), np.zeros(3))
    return scene
