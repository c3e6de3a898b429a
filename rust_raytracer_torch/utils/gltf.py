"""Minimal glTF 2.0 parser (.gltf / .glb) for `model:` asset import.

Covers what the reference's Assimp path consumes (assimp.rs:29-178):
node hierarchy with transforms, triangle meshes (POSITION / NORMAL /
TEXCOORD_0 + indices), PBR materials (baseColor / roughness factor and
textures, emissive), and the first perspective camera.  Pure
numpy + stdlib + PIL — no external glTF dependency.

Parsing only; scene-graph mapping lives in utils/model_import.py.

The port's copy of rust_raytracer_tpu/utils/gltf.py, held equal to it by
tests/test_torch_cli.py (both packages compile what it loads to equal
tables).
"""
from __future__ import annotations

import base64
import io
import json
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


@dataclass
class GltfPrimitive:
    positions: np.ndarray              # (V, 3) f32
    normals: Optional[np.ndarray]      # (V, 3) f32 or None
    uvs: Optional[np.ndarray]          # (V, 2) f32 or None
    indices: np.ndarray                # (T, 3) int64
    material: int                      # -1 = default material


@dataclass
class GltfMaterial:
    name: str = ""
    base_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    base_color_image: Optional[np.ndarray] = None   # (H, W, 3) f32 in [0,1]
    roughness: float = 1.0
    roughness_image: Optional[np.ndarray] = None
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    normal_image: Optional[np.ndarray] = None


@dataclass
class GltfCamera:
    position: np.ndarray   # (3,)
    look_at: np.ndarray    # (3,)
    yfov: float
    aspect: Optional[float]


@dataclass
class GltfScene:
    # one entry per mesh instance: primitive + world transform + the
    # accumulated node TRANSLATION (the reference's proxy-light position,
    # assimp.rs:76-80 accumulates only the translation column)
    instances: List[Tuple[GltfPrimitive, np.ndarray, np.ndarray]] = field(
        default_factory=list
    )
    materials: List[GltfMaterial] = field(default_factory=list)
    camera: Optional[GltfCamera] = None


def _read_glb(data: bytes) -> Tuple[dict, Optional[bytes]]:
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError("not a GLB file (bad magic)")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    off = 12
    doc = None
    bin_chunk = None
    while off + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        chunk = data[off: off + clen]
        off += clen
        if ctype == 0x4E4F534A:  # 'JSON'
            doc = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # 'BIN'
            bin_chunk = chunk
    if doc is None:
        raise ValueError("GLB missing JSON chunk")
    return doc, bin_chunk


def _load_buffer(buf: dict, base_dir: str, bin_chunk: Optional[bytes]) -> bytes:
    uri = buf.get("uri")
    if uri is None:
        if bin_chunk is None:
            raise ValueError("buffer without uri and no GLB BIN chunk")
        return bin_chunk
    if uri.startswith("data:"):
        b64 = uri.split(",", 1)[1]
        return base64.b64decode(b64)
    with open(os.path.join(base_dir, uri), "rb") as f:
        return f.read()


class _Doc:
    def __init__(self, doc: dict, base_dir: str, bin_chunk: Optional[bytes]):
        self.doc = doc
        self.buffers = [
            _load_buffer(b, base_dir, bin_chunk)
            for b in doc.get("buffers", [])
        ]
        self.base_dir = base_dir
        self._image_cache: Dict[int, np.ndarray] = {}

    def accessor(self, idx: int) -> np.ndarray:
        acc = self.doc["accessors"][idx]
        if acc.get("sparse"):
            raise NotImplementedError("sparse accessors are not supported")
        n = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
        if "bufferView" not in acc:
            return np.zeros((n, ncomp), dtype)
        bv = self.doc["bufferViews"][acc["bufferView"]]
        data = self.buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride") or dtype.itemsize * ncomp
        if stride == dtype.itemsize * ncomp:
            out = np.frombuffer(
                data, dtype, count=n * ncomp, offset=start
            ).reshape(n, ncomp)
        else:
            rows = np.frombuffer(
                data, np.uint8, count=(n - 1) * stride + dtype.itemsize * ncomp,
                offset=start,
            )
            idxs = (np.arange(n)[:, None] * stride
                    + np.arange(dtype.itemsize * ncomp)[None, :])
            out = rows[idxs].copy().view(dtype).reshape(n, ncomp)
        if acc.get("normalized") and dtype.kind == "u":
            out = out.astype(np.float32) / np.float32(np.iinfo(dtype).max)
        return out

    def image(self, tex_index: int) -> np.ndarray:
        """Decode the image behind texture `tex_index` to (H, W, 3) f32
        linear-ish [0,1] (nearest-sampled later, like texture/image.rs)."""
        if tex_index in self._image_cache:
            return self._image_cache[tex_index]
        from PIL import Image as PILImage

        tex = self.doc["textures"][tex_index]
        img = self.doc["images"][tex["source"]]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                raw = base64.b64decode(uri.split(",", 1)[1])
                pil = PILImage.open(io.BytesIO(raw))
            else:
                pil = PILImage.open(os.path.join(self.base_dir, uri))
        else:
            bv = self.doc["bufferViews"][img["bufferView"]]
            start = bv.get("byteOffset", 0)
            raw = self.buffers[bv["buffer"]][start: start + bv["byteLength"]]
            pil = PILImage.open(io.BytesIO(raw))
        arr = np.asarray(pil.convert("RGB"), np.float32) / 255.0
        self._image_cache[tex_index] = arr
        return arr


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0]) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        rm = np.eye(4)
        rm[:3, :3] = r
        m = rm @ m
    if "translation" in node:
        tm = np.eye(4)
        tm[:3, 3] = node["translation"]
        m = tm @ m
    return m


def load(path: str) -> GltfScene:
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        data = f.read()
    if path.lower().endswith(".glb") or data[:4] == b"glTF":
        doc, bin_chunk = _read_glb(data)
    else:
        doc = json.loads(data.decode("utf-8"))
        bin_chunk = None
    d = _Doc(doc, base_dir, bin_chunk)

    out = GltfScene()

    # materials
    for mdoc in doc.get("materials", []):
        m = GltfMaterial(name=mdoc.get("name", ""))
        pbr = mdoc.get("pbrMetallicRoughness", {})
        bc = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
        m.base_color = tuple(float(v) for v in bc[:3])
        if "baseColorTexture" in pbr:
            m.base_color_image = d.image(pbr["baseColorTexture"]["index"])
        m.roughness = float(pbr.get("roughnessFactor", 1.0))
        if "metallicRoughnessTexture" in pbr:
            m.roughness_image = d.image(
                pbr["metallicRoughnessTexture"]["index"]
            )
        em = mdoc.get("emissiveFactor", [0.0, 0.0, 0.0])
        strength = (
            mdoc.get("extensions", {})
            .get("KHR_materials_emissive_strength", {})
            .get("emissiveStrength", 1.0)
        )
        m.emissive = tuple(float(v) * float(strength) for v in em[:3])
        if "normalTexture" in mdoc:
            m.normal_image = d.image(mdoc["normalTexture"]["index"])
        out.materials.append(m)

    # mesh primitives (triangles only; glTF mode 4 is the default)
    prims_of_mesh: List[List[GltfPrimitive]] = []
    for mesh in doc.get("meshes", []):
        prims = []
        for p in mesh.get("primitives", []):
            if p.get("mode", 4) != 4:
                continue
            attrs = p["attributes"]
            pos = d.accessor(attrs["POSITION"]).astype(np.float32)
            nrm = (
                d.accessor(attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs else None
            )
            uv = (
                d.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs else None
            )
            if "indices" in p:
                idx = d.accessor(p["indices"]).astype(np.int64).ravel()
            else:
                idx = np.arange(pos.shape[0], dtype=np.int64)
            idx = idx[: (idx.shape[0] // 3) * 3].reshape(-1, 3)
            prims.append(GltfPrimitive(
                positions=pos, normals=nrm, uvs=uv, indices=idx,
                material=int(p.get("material", -1)),
            ))
        prims_of_mesh.append(prims)

    # node walk: accumulate full matrix (baked into vertices downstream)
    # and the translation-only position (the reference's proxy-light
    # convention, assimp.rs:76-80)
    nodes = doc.get("nodes", [])
    scene_idx = doc.get("scene", 0)
    roots = (
        doc["scenes"][scene_idx]["nodes"]
        if doc.get("scenes") else range(len(nodes))
    )

    def walk(ni: int, parent_m: np.ndarray, parent_t: np.ndarray):
        node = nodes[ni]
        local = _node_matrix(node)
        world = parent_m @ local
        tpos = parent_t + local[:3, 3]
        if "mesh" in node:
            for prim in prims_of_mesh[node["mesh"]]:
                out.instances.append((prim, world, tpos.copy()))
        if "camera" in node and out.camera is None:
            cam = doc["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                persp = cam["perspective"]
                position = world[:3, 3].copy()
                fwd = world[:3, :3] @ np.array([0.0, 0.0, -1.0])
                out.camera = GltfCamera(
                    position=position,
                    look_at=position + fwd,
                    yfov=float(persp["yfov"]),
                    aspect=(
                        float(persp["aspectRatio"])
                        if "aspectRatio" in persp else None
                    ),
                )
        for ch in node.get("children", []):
            walk(ch, world, tpos)

    for r in roots:
        walk(r, np.eye(4), np.zeros(3))

    return out
