"""Scene compiler: host graph -> numpy tables -> ScenePack on a device.

Source: `rust_raytracer_tpu/scene/compiler.py` (the JAX package).  This is
the same numpy code with the `jnp` wrapping removed, so the port compiles
scenes without importing JAX: transforms are baked into world-space
primitives, all meshes merge into one triangle soup under one BVH (threaded
binary + BVH8 collapse, from the port's copies `scene/bvh_builder.py` and
`scene/bvh8.py`), materials dedupe into a table, the texture DAG becomes a
static program (ops/texture.py) and the lights a static (kind, index) list.
Scenes are built with the port's own `scene/graph.py` (e.g. through its
`models.build`); a scene of another package's graph classes is refused.

The two compilers must stay leaf-for-leaf equal:
`tests/test_torch_scene.py::test_compile_scene_leaves_equal_jax` compiles
the same scenes with both and requires every ScenePack leaf to be equal in
shape, dtype and value.  Any change to one compiler must be made to the
other until the duplication is retired (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import texture as tex
from ..utils import metrics as metricsmod
from . import bvh8, bvh_builder, graph
from . import pack as sp

# Triangles per BVH leaf == per cluster row block (the reference's
# ops/pallas_intersect.CLUSTER), and rows of the reference's per-cluster
# geometry block (ops/pallas_intersect.GEOM_ROWS).
CLUSTER = 128
GEOM_ROWS = 16


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Static (trace-time) scene metadata."""
    tex_program: Tuple[tex.TexNode, ...]
    light_list: Tuple[Tuple[int, int], ...]


_SIMILARITY_TOL = 1e-6


def _is_uniform_similarity(m: np.ndarray) -> bool:
    """True when the 3x3 is a rotation times a single uniform scale —
    spheres stay spheres and the fast analytic path applies."""
    a = m[:3, :3]
    norms = np.linalg.norm(a, axis=0)
    if not np.allclose(norms, norms[0], rtol=1e-5):
        return False
    r = a / np.maximum(norms, 1e-30)
    return np.allclose(r.T @ r, np.eye(3), atol=1e-4)


def _has_orthogonal_columns(m: np.ndarray) -> bool:
    """True when the 3x3 columns are mutually orthogonal (rotation times
    per-axis scale, no shear) — the analytic oriented-box slab test holds."""
    a = m[:3, :3]
    r = a / np.maximum(np.linalg.norm(a, axis=0), 1e-30)
    return np.allclose(r.T @ r, np.eye(3), atol=1e-4)


def _decompose_similarity(m: np.ndarray):
    """Split the 3x3 of an affine into (rotation-ish columns, per-axis scale).
    Raises if columns are not orthogonal — callers that need exact
    orthogonal frames (box volume slabs) fall back to mesh boundaries for
    sheared instances."""
    a = m[:3, :3]
    norms = np.linalg.norm(a, axis=0)
    r = a / np.maximum(norms, 1e-30)
    gram = r.T @ r
    if not np.allclose(gram, np.eye(3), atol=1e-4):
        raise ValueError("sheared transforms are not supported (columns must be orthogonal)")
    return r, norms


def _plane_duals(u: np.ndarray, v: np.ndarray, n: np.ndarray):
    """Dual basis of the (possibly non-orthogonal) span (u, v): vectors
    du, dv with du.u = 1, du.v = 0, dv.v = 1, dv.u = 0 in the plane.
    Scaled by 1/2 so uv over the full 2u x 2v parallelogram is [0,1]."""
    vxn = np.cross(v, n)
    uxn = np.cross(u, n)
    d1 = float(np.dot(u, vxn))
    d2 = float(np.dot(v, uxn))
    du = vxn / (d1 if abs(d1) > 1e-30 else 1e-30)
    dv = uxn / (d2 if abs(d2) > 1e-30 else 1e-30)
    return du * 0.5, dv * 0.5


def _xform_point(m, p):
    return (m[:3, :3] @ np.asarray(p, np.float64)) + m[:3, 3]


def _xform_vec(m, v):
    return m[:3, :3] @ np.asarray(v, np.float64)


class _Compiler:
    def __init__(self, dtype=np.float32):
        self.dtype = dtype

        self.spheres: List[tuple] = []      # (center, radius, mat)
        self.planes: List[tuple] = []       # (corner, uhalf, vhalf, normal, area, backface, mat)
        self.meshes: List[tuple] = []       # per-mesh triangle arrays (pre-merge)
        self.volumes: List[tuple] = []
        self.skies: List[int] = []          # emission tex ids
        self.suns: List[tuple] = []         # (direction, tex)
        self.proxy_spheres: List[tuple] = []  # (center, radius) light-only

        self.materials: List[graph.Material] = []
        self._mat_ids: Dict[int, int] = {}

        self.tex_nodes: List[tex.TexNode] = []
        self._tex_ids: Dict[int, int] = {}
        self.tex_data: List[np.ndarray] = []

        # graph-node identity -> (kind, prim index) for light lookup
        self.prim_of: Dict[int, Tuple[int, int]] = {}

        # node 0: black constant (default/dummy texture)
        self.tex_nodes.append(tex.TexNode(kind=tex.CONSTANT, value=(0.0, 0.0, 0.0)))

    # ---------------- textures ----------------

    def compile_texture(self, t: Optional[graph.Texture]) -> int:
        if t is None:
            return 0
        key = id(t)
        if key in self._tex_ids:
            return self._tex_ids[key]

        if isinstance(t, graph.Constant):
            node = tex.TexNode(
                kind=tex.CONSTANT, value=t.vec3(), is_scalar=t.is_scalar
            )
        elif isinstance(t, graph.Checker):
            a = self.compile_texture(t.even)
            b = self.compile_texture(t.odd)
            node = tex.TexNode(
                kind=tex.CHECKER, children=(a, b), scale=float(t.scale),
                is_scalar=t.is_scalar,
            )
        elif isinstance(t, graph.CheckerSolid):
            a = self.compile_texture(t.even)
            b = self.compile_texture(t.odd)
            node = tex.TexNode(
                kind=tex.CHECKER_SOLID, children=(a, b), scale=float(t.scale),
                is_scalar=t.is_scalar,
            )
        elif isinstance(t, graph.Image):
            didx = len(self.tex_data)
            self.tex_data.append(np.asarray(t.pixels, self.dtype))
            node = tex.TexNode(
                kind=tex.IMAGE, data_idx=didx,
                repeat=tex.CLAMP if t.clamp else tex.REPEAT,
            )
        elif isinstance(t, graph.Lerp):
            a = self.compile_texture(t.a)
            b = self.compile_texture(t.b)
            c = self.compile_texture(t.t)
            node = tex.TexNode(kind=tex.LERP, children=(a, b, c),
                               is_scalar=t.is_scalar)
        elif isinstance(t, graph.NoiseSolid):
            g, px, py, pz = t.noise.tables()
            didx = len(self.tex_data)
            self.tex_data += [g.astype(self.dtype), px, py, pz]
            node = tex.TexNode(
                kind=tex.NOISE_SOLID, data_idx=didx, scale=float(t.scale),
                samples=int(t.samples), noise_map=t.map, is_scalar=True,
            )
        elif isinstance(t, graph.Channel):
            a = self.compile_texture(t.source)
            node = tex.TexNode(kind=tex.CHANNEL, children=(a,),
                               channel=int(t.channel), is_scalar=True)
        elif isinstance(t, graph.UvDebug):
            node = tex.TexNode(kind=tex.UV_DEBUG)
        else:
            raise TypeError(f"unknown texture type {type(t)}")

        self.tex_nodes.append(node)
        idx = len(self.tex_nodes) - 1
        self._tex_ids[key] = idx
        return idx

    # ---------------- materials ----------------

    def compile_material(self, m: graph.Material) -> int:
        key = id(m)
        if key in self._mat_ids:
            return self._mat_ids[key]
        self.materials.append(m)
        idx = len(self.materials) - 1
        self._mat_ids[key] = idx
        return idx

    def material_table(self):
        n = max(1, len(self.materials))
        mtype = np.zeros((n,), np.int32)
        alb = np.zeros((n,), np.int32)
        rough = np.zeros((n,), np.int32)
        inv_ior = np.ones((n,), self.dtype)
        ior = np.full((n,), 1.5, self.dtype)
        nmap = np.full((n,), -1, np.int32)
        for i, m in enumerate(self.materials):
            if isinstance(m, graph.Lambertian):
                mtype[i] = sp.MAT_LAMBERTIAN
                alb[i] = self.compile_texture(m.albedo)
            elif isinstance(m, graph.Metal):
                mtype[i] = sp.MAT_METAL
                alb[i] = self.compile_texture(m.albedo)
                rough[i] = self.compile_texture(m.roughness)
            elif isinstance(m, graph.Dielectric):
                mtype[i] = sp.MAT_DIELECTRIC
                ior[i] = m.ior
            elif isinstance(m, graph.Glossy):
                mtype[i] = sp.MAT_GLOSSY
                alb[i] = self.compile_texture(m.albedo)
                rough[i] = self.compile_texture(m.roughness)
                inv_ior[i] = 1.0 / m.ior
                if m.normal_map is not None:
                    nmap[i] = self.compile_texture(m.normal_map)
            elif isinstance(m, graph.Emissive):
                mtype[i] = sp.MAT_EMISSIVE
                alb[i] = self.compile_texture(m.emission)
            elif isinstance(m, graph.Isotropic):
                mtype[i] = sp.MAT_ISOTROPIC
                alb[i] = self.compile_texture(m.albedo)
            elif isinstance(m, graph.NormalDebug):
                mtype[i] = sp.MAT_NORMAL_DEBUG
                if m.normal_map is not None:
                    nmap[i] = self.compile_texture(m.normal_map)
            else:
                raise TypeError(f"unknown material type {type(m)}")
        return mtype, alb, rough, inv_ior, ior, nmap

    # ---------------- objects ----------------

    def compile_object(self, obj: graph.Object, m: np.ndarray):
        if isinstance(obj, graph.Group):
            for item in obj.items:
                self.compile_object(item, m)
        elif isinstance(obj, graph.Transform):
            self.compile_object(obj.obj, m @ obj.matrix)
        elif isinstance(obj, graph.Sphere):
            c = _xform_point(m, obj.center)
            if _is_uniform_similarity(m):
                scale = float(np.linalg.norm(m[:3, 0]))
                r = float(obj.radius) * scale
                affine = None
            else:
                # ellipsoid instance: world -> unit-sphere map
                # (the reference transforms the ray per instance,
                # transform.rs:122-139)
                r = float(obj.radius)
                fwd = m[:3, :3] * r
                affine = (np.linalg.inv(fwd), fwd)
            self.spheres.append(
                (c, r, self.compile_material(obj.material), affine)
            )
            self.prim_of[id(obj)] = (sp.PRIM_SPHERE, len(self.spheres) - 1)
        elif isinstance(obj, graph.Plane):
            c = _xform_point(m, obj.center)
            u = _xform_vec(m, obj.u)
            v = _xform_vec(m, obj.v)
            nvec = np.cross(u, v)
            area = float(np.linalg.norm(nvec)) * 4.0
            normal = nvec / max(np.linalg.norm(nvec), 1e-30)
            corner = c - u - v  # corners[3] in plane.rs:39-49
            du, dv = _plane_duals(u, v, normal)
            self.planes.append(
                (corner, u, v, du, dv, normal, area,
                 bool(obj.render_backface),
                 self.compile_material(obj.material))
            )
            self.prim_of[id(obj)] = (sp.PRIM_PLANE, len(self.planes) - 1)
        elif isinstance(obj, graph.Box):
            self.compile_object(obj.planes(), m)
        elif isinstance(obj, graph.Mesh):
            self._compile_mesh(obj, m)
        elif isinstance(obj, graph.Volume):
            self._compile_volume(obj, m)
        elif isinstance(obj, graph.Sky):
            self.skies.append(self.compile_texture(obj.emission))
            self.prim_of[id(obj)] = (sp.PRIM_SKY, len(self.skies) - 1)
        elif isinstance(obj, graph.Sun):
            d = np.asarray(obj.direction, np.float64)
            d = d / np.linalg.norm(d)
            self.suns.append((d, self.compile_texture(obj.emission)))
            self.prim_of[id(obj)] = (sp.PRIM_SUN, len(self.suns) - 1)
        else:
            raise TypeError(f"unknown object type {type(obj)}")

    def _compile_mesh(self, mesh: graph.Mesh, m: np.ndarray):
        mat = self.compile_material(mesh.material)
        tris = np.asarray(mesh.triangles, np.int64)
        nt = tris.shape[0]
        if nt == 0:
            return
        verts = np.asarray(mesh.vertices, np.float64)
        verts_w = verts @ m[:3, :3].T + m[:3, 3]
        v0 = verts_w[tris[:, 0, 0]]
        v1 = verts_w[tris[:, 1, 0]]
        v2 = verts_w[tris[:, 2, 0]]
        e1 = v1 - v0
        e2 = v2 - v0

        if mesh.flat_shading or mesh.normals.shape[0] == 0:
            face_n = np.cross(e1, e2)
            face_n /= np.maximum(np.linalg.norm(face_n, axis=-1, keepdims=True), 1e-30)
            n0 = n1 = n2 = face_n
        else:
            normals = np.asarray(mesh.normals, np.float64)
            nrm_w = normals @ m[:3, :3].T  # forward matrix, matching
            # transform.rs:133 (valid absent shear); normalized below
            nrm_w /= np.maximum(np.linalg.norm(nrm_w, axis=-1, keepdims=True), 1e-30)
            n0 = nrm_w[tris[:, 0, 1]]
            n1 = nrm_w[tris[:, 1, 1]]
            n2 = nrm_w[tris[:, 2, 1]]

        has_uv = tris[:, 0, 2] >= 0
        if mesh.uvs.shape[0] > 0:
            uvs = np.asarray(mesh.uvs, np.float64)
            iu = np.maximum(tris[:, :, 2], 0)
            uv0, uv1, uv2 = uvs[iu[:, 0]], uvs[iu[:, 1]], uvs[iu[:, 2]]
        else:
            uv0 = uv1 = uv2 = np.zeros((nt, 2))
            has_uv = np.zeros((nt,), bool)

        self.meshes.append(
            dict(
                v0=v0, e1=e1, e2=e2, n0=n0, n1=n1, n2=n2,
                uv0=uv0, uv1=uv1, uv2=uv2, has_uv=has_uv,
                hit_back=np.full((nt,), mesh.hit_back_faces, bool),
                mat=np.full((nt,), mat, np.int32),
            )
        )

    def _compile_volume(self, vol: graph.Volume, m: np.ndarray):
        """Constant-density media.  The reference accepts ANY convex `Hit`
        as the boundary (volume.rs:34-37); here: spheres (incl. ellipsoid
        instances) and orthogonal boxes are analytic, everything else —
        sheared boxes, triangle meshes — compiles to a per-volume padded
        triangle block whose entry/exit span the intersector computes by
        min / second-min crossing (convex => exactly two)."""
        mat = self.compile_material(vol.material)
        boundary = vol.boundary
        bm = m.copy()
        while isinstance(boundary, graph.Transform):
            bm = bm @ boundary.matrix
            boundary = boundary.obj
        nid = -1.0 / vol.density
        if isinstance(boundary, graph.Sphere):
            c = _xform_point(bm, boundary.center)
            if _is_uniform_similarity(bm):
                scale = float(np.linalg.norm(bm[:3, 0]))
                r = float(boundary.radius) * scale
                axes = np.eye(3) / r
            else:
                r = float(boundary.radius)
                axes = np.linalg.inv(bm[:3, :3] * r)  # world -> unit sphere
            self.volumes.append(
                (sp.VOL_SPHERE, c, r, axes, np.ones(3), nid, mat, None)
            )
            return
        if isinstance(boundary, graph.Box) and _has_orthogonal_columns(bm):
            rot, scale = _decompose_similarity(bm)
            c = _xform_point(bm, boundary.center)
            half = np.asarray(boundary.size, np.float64) / 2.0 * scale
            self.volumes.append(
                (sp.VOL_BOX, c, 0.0, rot.T, half, nid, mat, None)
            )
            return

        # mesh boundary: transformed triangles of a Box tessellation or an
        # arbitrary (convex) Mesh
        if isinstance(boundary, graph.Box):
            cx = np.asarray(boundary.center, np.float64)
            hx = np.asarray(boundary.size, np.float64) / 2.0
            corners = np.array([
                cx + hx * np.array(s)
                for s in [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
                          (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
            ])
            quads = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
                     (2, 3, 7, 6), (0, 3, 7, 4), (1, 2, 6, 5)]
            tri_idx = []
            for a, b, c2, d in quads:
                tri_idx += [(a, b, c2), (a, c2, d)]
            verts = corners
            tris = np.asarray(tri_idx, np.int64)
        elif isinstance(boundary, graph.Mesh):
            verts = np.asarray(boundary.vertices, np.float64)
            tris = np.asarray(boundary.triangles, np.int64)[:, :, 0]
        else:
            raise TypeError(
                "volume boundaries must be spheres, boxes or meshes "
                f"(got {type(boundary)})"
            )
        verts_w = verts @ bm[:3, :3].T + bm[:3, 3]
        v0 = verts_w[tris[:, 0]]
        e1 = verts_w[tris[:, 1]] - v0
        e2 = verts_w[tris[:, 2]] - v0
        self.volumes.append(
            (sp.VOL_MESH, np.zeros(3), 0.0, np.eye(3), np.ones(3),
             nid, mat, (v0, e1, e2))
        )

    # ---------------- lights ----------------

    def light_entry(self, obj: graph.Object) -> List[Tuple[int, int]]:
        if isinstance(obj, graph.Group):
            out = []
            for item in obj.items:
                out += self.light_entry(item)
            return out
        if isinstance(obj, graph.Transform):
            return self.light_entry(obj.obj)
        if isinstance(obj, graph.ProxySphereLight):
            # invisible sampling sphere: lives only in the light tables,
            # never in the intersectable world (assimp.rs:123-129)
            self.proxy_spheres.append(
                (np.asarray(obj.center, np.float64), float(obj.radius))
            )
            return [(sp.LIGHT_PROXY, len(self.proxy_spheres) - 1)]
        kind_idx = self.prim_of.get(id(obj))
        if kind_idx is None:
            raise ValueError(
                "light object must also be part of the world "
                f"(unplaced {type(obj).__name__})"
            )
        kind, idx = kind_idx
        if kind == sp.PRIM_SPHERE and self.spheres[idx][3] is not None:
            raise ValueError(
                "ellipsoid (non-uniformly scaled/sheared) spheres cannot be "
                "importance-sampled lights — the reference's Transform "
                "wrapper has pdf 0 there too (transform.rs:141-151)"
            )
        kind_map = {
            sp.PRIM_SPHERE: sp.LIGHT_SPHERE,
            sp.PRIM_PLANE: sp.LIGHT_PLANE,
            sp.PRIM_SKY: sp.LIGHT_SKY,
            sp.PRIM_SUN: sp.LIGHT_SUN,
        }
        if kind not in kind_map:
            # meshes/volumes have pdf 0 in the reference (mesh.rs:209-215)
            # and contribute nothing to NEE; drop with the same effect
            return []
        return [(kind_map[kind], idx)]


def _tri_attr_rows(v0, e1, e2, n0, n1, n2, uv0, uv1, uv2, has_uv,
                   hit_back, tmat):
    """Pack the per-triangle attribute columns into (T, 32) rows (layout
    documented at ScenePack.tri_attr) so hit_attributes pays one row
    gather per lane."""
    nt = np.asarray(v0).shape[0]
    rows = np.zeros((nt, 32), np.float64)
    if nt:
        rows[:, 0:3] = v0
        rows[:, 3:6] = e1
        rows[:, 6:9] = e2
        rows[:, 9:12] = n0
        rows[:, 12:15] = n1
        rows[:, 15:18] = n2
        rows[:, 18:20] = uv0
        rows[:, 20:22] = uv1
        rows[:, 22:24] = uv2
        rows[:, 24] = np.asarray(has_uv, np.float64)
        rows[:, 25] = np.asarray(hit_back, np.float64)
        rows[:, 26] = np.asarray(tmat, np.float64)
    return rows



def _supernodes(bvh_min, bvh_max, bvh_miss, bvh_leaf, cluster, n_cl,
                cl_lo, cl_hi, sn_cap=128, big=3.4e38):
    """Supernode grouping for the reference's two-level wavefront pipeline:
    maximal preorder BVH subtrees covering <= sn_cap leaf clusters, with
    tight boxes and contiguous cluster ranges; fixed-stride groups if the
    builder's leaf order ever breaks contiguity."""
    m = bvh_min.shape[0]
    is_leaf_n = bvh_leaf >= 0
    pref = np.concatenate([[0], np.cumsum(is_leaf_n)])
    starts, lo_l, hi_l = [], [], []
    covered = []
    i = 0
    ok = True
    while i < m and ok:
        skip = int(bvh_miss[i])
        if skip <= i:
            skip = m
        cnt = int(pref[skip] - pref[i])
        if cnt <= sn_cap:
            sub = np.arange(i, skip)
            cls = np.sort(bvh_leaf[sub[is_leaf_n[i:skip]]] // cluster)
            if cnt:
                if cls[-1] - cls[0] + 1 != len(cls):
                    ok = False
                    break
                starts.append(int(cls[0]))
                lo_l.append(bvh_min[i])
                hi_l.append(bvh_max[i])
                covered.append(cls)
            i = skip
        else:
            i += 1
    if ok and covered:
        allc = np.concatenate(covered)
        ok = len(allc) == n_cl and len(np.unique(allc)) == n_cl
    if not ok or not covered:
        starts = list(range(0, n_cl, sn_cap))
        lo_l = [cl_lo[s:s + sn_cap].min(0) for s in starts]
        hi_l = [
            np.where(cl_hi[s:s + sn_cap].max(0) <= -big,
                     cl_lo[s:s + sn_cap].min(0),
                     cl_hi[s:s + sn_cap].max(0))
            for s in starts
        ]
        covered = [np.arange(s, min(s + sn_cap, n_cl)) for s in starts]
    S = len(starts)
    sn_lo = np.asarray(lo_l, np.float32).reshape(S, 3)
    sn_hi = np.asarray(hi_l, np.float32).reshape(S, 3)
    sn_start = np.asarray(starts, np.int32)
    bounds = np.full((S, 6, sn_cap), big, np.float32)
    for s in range(S):
        cnt = len(covered[s])
        c0 = starts[s]
        bounds[s, 0:3, :cnt] = cl_lo[c0:c0 + cnt].T
        bounds[s, 3:6, :cnt] = cl_hi[c0:c0 + cnt].T
    return sn_lo, sn_hi, sn_start, bounds


def _device_dtype(a: np.ndarray, dtype=np.float32) -> np.ndarray:
    """The dtype a table has on the device: 64-bit integers become 32-bit,
    as the reference's `jnp.asarray` does, and at the f32 compile dtype
    64-bit floats become 32-bit too (the reference's 64-bit mode off).  At
    f64 the float tables keep their dtype: the f32 traversal tables stay
    f32, the rest are f64."""
    a = np.asarray(a)
    narrow = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32}
    if np.dtype(dtype) == np.float32:
        narrow[np.dtype(np.float64)] = np.float32
    return a.astype(narrow[a.dtype]) if a.dtype in narrow else a


def compile_numpy(scene: graph.SceneDef, dtype=np.float32):
    """Compile a host scene graph into numpy tables.

    Returns (leaves, tex_data, static): `leaves` maps every ScenePack leaf
    name (scene/pack.LEAF_FIELDS) to a numpy array of its device dtype,
    `tex_data` is the tuple of texture tables, `static` the SceneStatic.
    `dtype` (np.float32 or np.float64) is the dtype of every float table
    that the reference builds in the compile dtype; the traversal tables
    (`bvh_rows`, `tri_geom`, `bvh8_aabb`, `wf_*`) are f32 at any dtype, as
    the reference's (rust_raytracer_tpu/scene/compiler.py:570-672).
    """
    if not isinstance(scene, graph.SceneDef):
        raise TypeError(
            f"expected a {graph.SceneDef.__module__}.SceneDef, got "
            f"{type(scene).__module__}.{type(scene).__qualname__}: build scenes with "
            "the port's own scene graph (rust_raytracer_torch.scene.graph, "
            "rust_raytracer_torch.models)")
    np_dtype = np.dtype(dtype)
    if np_dtype not in (np.float32, np.float64):
        raise TypeError(f"compile dtype must be float32 or float64, got {np_dtype}")
    c = _Compiler(dtype=np_dtype)
    c.compile_object(scene.world, np.eye(4))

    light_list: List[Tuple[int, int]] = []
    for lobj in scene.lights:
        light_list += c.light_entry(lobj)

    mtype, alb, rough, inv_ior, ior, nmap = c.material_table()

    f = lambda x: np.asarray(x, np_dtype)
    i = lambda x: np.asarray(x, np.int32)
    b = lambda x: np.asarray(x, bool)

    # --- spheres ---
    ns = len(c.spheres)
    sph_center = np.array([s[0] for s in c.spheres], np.float64).reshape(ns, 3)
    sph_radius = np.array([s[1] for s in c.spheres], np.float64)
    sph_mat = np.array([s[2] for s in c.spheres], np.int32)
    if any(s[3] is not None for s in c.spheres):
        sph_inv = np.stack([
            s[3][0] if s[3] is not None else np.eye(3) / s[1]
            for s in c.spheres
        ])
        sph_fwd = np.stack([
            s[3][1] if s[3] is not None else np.eye(3) * s[1]
            for s in c.spheres
        ])
    else:
        sph_inv = np.zeros((0, 3, 3))
        sph_fwd = np.zeros((0, 3, 3))

    # --- planes ---
    npl = len(c.planes)
    pln = c.planes
    pln_corner = np.array([p[0] for p in pln], np.float64).reshape(npl, 3)
    pln_u = np.array([p[1] for p in pln], np.float64).reshape(npl, 3)
    pln_v = np.array([p[2] for p in pln], np.float64).reshape(npl, 3)
    pln_du = np.array([p[3] for p in pln], np.float64).reshape(npl, 3)
    pln_dv = np.array([p[4] for p in pln], np.float64).reshape(npl, 3)
    pln_n = np.array([p[5] for p in pln], np.float64).reshape(npl, 3)
    pln_area = np.array([p[6] for p in pln], np.float64)
    pln_bf = np.array([p[7] for p in pln], bool)
    pln_mat = np.array([p[8] for p in pln], np.int32)

    # --- triangles: merge meshes, reorder by BVH, pad leaves ---
    if c.meshes:
        cat = lambda k: np.concatenate([msh[k] for msh in c.meshes], axis=0)
        v0, e1, e2 = cat("v0"), cat("e1"), cat("e2")
        n0, n1, n2 = cat("n0"), cat("n1"), cat("n2")
        uv0, uv1, uv2 = cat("uv0"), cat("uv1"), cat("uv2")
        has_uv, hit_back, tmat = cat("has_uv"), cat("hit_back"), cat("mat")

        cluster = CLUSTER
        tri_lo = np.minimum(v0, np.minimum(v0 + e1, v0 + e2)) - 1e-4
        tri_hi = np.maximum(v0, np.maximum(v0 + e1, v0 + e2)) + 1e-4
        bvh = bvh_builder.build(
            tri_lo.astype(np.float32), tri_hi.astype(np.float32),
            leaf_size=cluster,
        )
        tri_order = bvh.tri_order

        def reorder(a, fill=0.0):
            out = np.full((len(tri_order),) + a.shape[1:], fill, a.dtype)
            ok = tri_order >= 0
            out[ok] = a[tri_order[ok]]
            return out

        v0, e1, e2 = reorder(v0), reorder(e1), reorder(e2)
        n0, n1, n2 = reorder(n0), reorder(n1), reorder(n2)
        uv0, uv1, uv2 = reorder(uv0), reorder(uv1), reorder(uv2)
        has_uv = reorder(has_uv, False)
        hit_back = reorder(hit_back, False)
        tmat = reorder(tmat, 0)
        bvh_min, bvh_max = bvh.node_min, bvh.node_max
        bvh_hit, bvh_miss, bvh_leaf = bvh.hit_link, bvh.miss_link, bvh.leaf_start

        m = bvh_min.shape[0]
        bvh_rows = np.zeros((m, 16), np.float32)
        bvh_rows[:, 0:3] = bvh_min
        bvh_rows[:, 3:6] = bvh_max
        bvh_rows[:, 6] = bvh_hit.astype(np.float32)
        bvh_rows[:, 7] = bvh_miss.astype(np.float32)
        is_leaf = bvh_leaf >= 0
        bvh_rows[:, 8] = np.where(is_leaf, bvh_leaf // cluster + 1, 0).astype(
            np.float32
        )

        n_clusters = len(tri_order) // cluster
        tri_geom = np.zeros((n_clusters, GEOM_ROWS, cluster), np.float32)
        by_cluster = lambda a: a.astype(np.float32).reshape(
            n_clusters, cluster, -1
        ).transpose(0, 2, 1)
        tri_geom[:, 0:3] = by_cluster(v0)
        tri_geom[:, 3:6] = by_cluster(e1)
        tri_geom[:, 6:9] = by_cluster(e2)
        tri_geom[:, 9:10] = by_cluster(hit_back)

        b8 = bvh8.collapse(bvh, cluster)
        bvh8_aabb, bvh8_child = b8.aabb8, b8.child8

        n_cl = len(tri_order) // cluster
        wf_cl_lo = np.full((n_cl, 3), 3.4e38, np.float32)
        wf_cl_hi = np.full((n_cl, 3), -3.4e38, np.float32)
        leafs = bvh_leaf >= 0
        cl_ids = bvh_leaf[leafs] // cluster
        wf_cl_lo[cl_ids] = bvh_min[leafs]
        wf_cl_hi[cl_ids] = bvh_max[leafs]
        wf_sn_lo, wf_sn_hi, wf_sn_start, wf_sn_bounds = _supernodes(
            bvh_min, bvh_max, bvh_miss, bvh_leaf, cluster, n_cl,
            wf_cl_lo, wf_cl_hi)
    else:
        v0 = e1 = e2 = n0 = n1 = n2 = np.zeros((0, 3))
        uv0 = uv1 = uv2 = np.zeros((0, 2))
        has_uv = hit_back = np.zeros((0,), bool)
        tmat = np.zeros((0,), np.int32)
        bvh_min = bvh_max = np.zeros((0, 3), np.float32)
        bvh_hit = bvh_miss = bvh_leaf = np.zeros((0,), np.int32)
        bvh_rows = np.zeros((0, 16), np.float32)
        tri_geom = np.zeros((0, 16, 128), np.float32)
        bvh8_aabb = np.zeros((0, 8, 128), np.float32)
        bvh8_child = np.zeros((0, 8), np.int32)
        wf_cl_lo = wf_cl_hi = np.zeros((0, 3), np.float32)
        wf_sn_lo = wf_sn_hi = np.zeros((0, 3), np.float32)
        wf_sn_start = np.zeros((0,), np.int32)
        wf_sn_bounds = np.zeros((0, 6, 128), np.float32)

    # --- volumes ---
    nv = len(c.volumes)
    vol_kind = np.array([v[0] for v in c.volumes], np.int32)
    vol_center = np.array([v[1] for v in c.volumes], np.float64).reshape(nv, 3)
    vol_radius = np.array([v[2] for v in c.volumes], np.float64)
    vol_axes = np.array([v[3] for v in c.volumes], np.float64).reshape(nv, 3, 3)
    vol_half = np.array([v[4] for v in c.volumes], np.float64).reshape(nv, 3)
    vol_nid = np.array([v[5] for v in c.volumes], np.float64)
    vol_mat = np.array([v[6] for v in c.volumes], np.int32)
    tb = max([v[7][0].shape[0] for v in c.volumes if v[7] is not None],
             default=0)
    tb = max(tb, 1)
    vol_tv0 = np.zeros((nv, tb, 3))
    vol_te1 = np.zeros((nv, tb, 3))
    vol_te2 = np.zeros((nv, tb, 3))
    for vi, v in enumerate(c.volumes):
        if v[7] is not None:
            tv0, te1, te2 = v[7]
            k = tv0.shape[0]
            vol_tv0[vi, :k] = tv0
            vol_te1[vi, :k] = te1
            vol_te2[vi, :k] = te2

    # --- sky / sun ---
    nsun = len(c.suns)
    sun_dir = np.array([s[0] for s in c.suns], np.float64).reshape(nsun, 3)
    sun_tex = np.array([s[1] for s in c.suns], np.int32)

    background = np.asarray(scene.config.get("background", (0.0, 0.0, 0.0)), np.float64)

    leaves = dict(
        sph_center=f(sph_center), sph_radius=f(sph_radius), sph_mat=i(sph_mat),
        sph_inv=f(sph_inv), sph_fwd=f(sph_fwd),
        pln_corner=f(pln_corner), pln_uhalf=f(pln_u), pln_vhalf=f(pln_v),
        pln_dual_u=f(pln_du), pln_dual_v=f(pln_dv),
        pln_normal=f(pln_n), pln_area=f(pln_area), pln_backface=b(pln_bf),
        pln_mat=i(pln_mat),
        tri_v0=f(v0), tri_e1=f(e1), tri_e2=f(e2),
        tri_n0=f(n0), tri_n1=f(n1), tri_n2=f(n2),
        tri_uv0=f(uv0), tri_uv1=f(uv1), tri_uv2=f(uv2),
        tri_has_uv=b(has_uv), tri_hit_back=b(hit_back), tri_mat=i(tmat),
        tri_attr=f(_tri_attr_rows(v0, e1, e2, n0, n1, n2, uv0, uv1, uv2,
                                  has_uv, hit_back, tmat)),
        bvh_min=f(bvh_min), bvh_max=f(bvh_max),
        bvh_hit_link=i(bvh_hit), bvh_miss_link=i(bvh_miss),
        bvh_leaf_start=i(bvh_leaf),
        bvh_rows=bvh_rows, tri_geom=tri_geom,
        bvh8_aabb=bvh8_aabb, bvh8_child=bvh8_child,
        wf_cl_lo=wf_cl_lo, wf_cl_hi=wf_cl_hi,
        wf_sn_lo=wf_sn_lo, wf_sn_hi=wf_sn_hi,
        wf_sn_start=wf_sn_start, wf_sn_bounds=wf_sn_bounds,
        vol_kind=i(vol_kind), vol_center=f(vol_center), vol_radius=f(vol_radius),
        vol_axes=f(vol_axes), vol_halfsize=f(vol_half),
        vol_neg_inv_density=f(vol_nid), vol_mat=i(vol_mat),
        vol_tri_v0=f(vol_tv0), vol_tri_e1=f(vol_te1), vol_tri_e2=f(vol_te2),
        sky_tex=i(np.asarray(c.skies, np.int32)),
        sun_dir=f(sun_dir), sun_tex=i(sun_tex),
        mat_type=i(mtype), mat_albedo_tex=i(alb), mat_rough_tex=i(rough),
        mat_inv_ior=f(inv_ior), mat_ior=f(ior), mat_normal_tex=i(nmap),
        light_kind=i(np.asarray([k for k, _ in light_list], np.int32)),
        light_idx=i(np.asarray([x for _, x in light_list], np.int32)),
        lgt_sph_center=f(np.array([p[0] for p in c.proxy_spheres],
                                  np.float64).reshape(len(c.proxy_spheres), 3)),
        lgt_sph_radius=f(np.array([p[1] for p in c.proxy_spheres], np.float64)),
        tex_const=f(np.array([n.value for n in c.tex_nodes], np.float64)),
        background=f(background),
    )
    leaves = {k: _device_dtype(v, np_dtype) for k, v in leaves.items()}
    tex_data = tuple(_device_dtype(d, np_dtype) for d in c.tex_data)
    static = SceneStatic(
        tex_program=tuple(c.tex_nodes), light_list=tuple(light_list)
    )
    return leaves, tex_data, static


def compile_scene(scene: graph.SceneDef, device, dtype=torch.float32):
    """Compile a host scene graph into (ScenePack on `device`, SceneStatic).
    `dtype` is torch.float32, or torch.float64 for the validation trace
    (its pack runs only the "jnp" walk, ops/intersect.py).  Each compile
    adds to utils/metrics.totals()'s "scene.compile"."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}.get(dtype)
    if np_dtype is None:
        raise TypeError(f"compile dtype must be torch.float32 or torch.float64, got {dtype}")
    with metricsmod.timed("scene.compile"):
        leaves, tex_data, static = compile_numpy(scene, np_dtype)
        return sp.from_numpy(leaves, tex_data, device), static
