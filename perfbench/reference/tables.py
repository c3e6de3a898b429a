"""Scene tables of the benchmark's plain reference: a scene description
(reference/graph.py) flattened into tensors on one device.

Worked out here from the scene description alone, never taken from the
program: transforms are baked into world-space primitives, the meshes are
merged into one triangle list in their own order (no BVH: the reference
finds its hits by its own search, reference/hits.py), materials are
numbered as they are met, the texture DAG becomes a static program
(reference/texture.py) and the lights a static (kind, index) list.  The
table names and layouts follow the program's plain shading code, of which
reference/shade.py, lights.py and hits.py are frozen copies, so that a
gradient of the reference and of the program can be compared table by
table by name.  Volumes are not supported: no benchmark scene has one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import graph
from . import texture as tex

# Material type ids
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_GLOSSY = 3
MAT_EMISSIVE = 4
MAT_ISOTROPIC = 5
MAT_NORMAL_DEBUG = 6

# Primitive kinds
PRIM_NONE = 0
PRIM_SPHERE = 1
PRIM_PLANE = 2
PRIM_TRIANGLE = 3
PRIM_VOLUME = 4
PRIM_SKY = 5
PRIM_SUN = 6

# Light kinds
LIGHT_SPHERE = 0
LIGHT_PLANE = 1
LIGHT_SKY = 2
LIGHT_SUN = 3
LIGHT_PROXY = 4

# The float tables that are the scene's parameters (what a gradient is of).
FLOAT_FIELDS = (
    "sph_center", "sph_radius", "sph_inv", "sph_fwd",
    "pln_corner", "pln_uhalf", "pln_vhalf", "pln_dual_u", "pln_dual_v", "pln_normal",
    "pln_area", "tri_attr", "sun_dir", "mat_inv_ior", "mat_ior", "lgt_sph_center",
    "lgt_sph_radius", "tex_const", "background",
)


@dataclasses.dataclass
class Scene:
    """The reference's tables (one attribute a table) and its static
    program: `tex_program`, `light_list`; `tri_rows` (T, 10) are
    the triangles' v0, e1, e2 and hit-back flag that reference/hits.py
    searches."""
    tensors: Dict[str, torch.Tensor]
    tex_program: tuple
    light_list: tuple

    def __getattr__(self, name):
        try:
            return self.__dict__["tensors"][name]
        except KeyError:
            raise AttributeError(name) from None

    @property
    def device(self):
        return self.tensors["background"].device

    def with_tables(self, **tables) -> "Scene":
        """The same scene with some tables replaced (leaves for a gradient,
        or a lower precision's copy)."""
        return dataclasses.replace(self, tensors={**self.tensors, **tables})


def _is_uniform_similarity(m: np.ndarray) -> bool:
    a = m[:3, :3]
    norms = np.linalg.norm(a, axis=0)
    if not np.allclose(norms, norms[0], rtol=1e-5):
        return False
    r = a / np.maximum(norms, 1e-30)
    return np.allclose(r.T @ r, np.eye(3), atol=1e-4)


def _plane_duals(u: np.ndarray, v: np.ndarray, n: np.ndarray):
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


class _Flattener:
    def __init__(self):
        self.spheres: List[tuple] = []
        self.planes: List[tuple] = []
        self.meshes: List[dict] = []
        self.skies: List[int] = []
        self.suns: List[tuple] = []
        self.materials: List[graph.Material] = []
        self._mat_ids: Dict[int, int] = {}
        self.tex_nodes: List[tex.TexNode] = [tex.TexNode(kind=tex.CONSTANT)]
        self._tex_ids: Dict[int, int] = {}
        self.prim_of: Dict[int, Tuple[int, int]] = {}

    def texture(self, t) -> int:
        if t is None:
            return 0
        if id(t) in self._tex_ids:
            return self._tex_ids[id(t)]
        if isinstance(t, graph.Constant):
            node = tex.TexNode(kind=tex.CONSTANT, value=t.vec3(), is_scalar=t.is_scalar)
        elif isinstance(t, graph.Checker):
            a, b = self.texture(t.even), self.texture(t.odd)
            node = tex.TexNode(kind=tex.CHECKER, children=(a, b), scale=float(t.scale),
                               is_scalar=t.is_scalar)
        else:
            raise TypeError(f"the reference has no texture {type(t).__name__}")
        self.tex_nodes.append(node)
        self._tex_ids[id(t)] = len(self.tex_nodes) - 1
        return len(self.tex_nodes) - 1

    def material(self, m) -> int:
        if id(m) not in self._mat_ids:
            self.materials.append(m)
            self._mat_ids[id(m)] = len(self.materials) - 1
        return self._mat_ids[id(m)]

    def material_table(self):
        n = max(1, len(self.materials))
        mtype = np.zeros((n,), np.int32)
        alb = np.zeros((n,), np.int32)
        rough = np.zeros((n,), np.int32)
        inv_ior = np.ones((n,), np.float32)
        ior = np.full((n,), 1.5, np.float32)
        nmap = np.full((n,), -1, np.int32)
        for i, m in enumerate(self.materials):
            if isinstance(m, graph.Lambertian):
                mtype[i], alb[i] = MAT_LAMBERTIAN, self.texture(m.albedo)
            elif isinstance(m, graph.Metal):
                mtype[i], alb[i] = MAT_METAL, self.texture(m.albedo)
                rough[i] = self.texture(m.roughness)
            elif isinstance(m, graph.Dielectric):
                mtype[i], ior[i] = MAT_DIELECTRIC, m.ior
            elif isinstance(m, graph.Glossy):
                mtype[i], alb[i] = MAT_GLOSSY, self.texture(m.albedo)
                rough[i] = self.texture(m.roughness)
                inv_ior[i] = 1.0 / m.ior
                if m.normal_map is not None:
                    nmap[i] = self.texture(m.normal_map)
            elif isinstance(m, graph.Emissive):
                mtype[i], alb[i] = MAT_EMISSIVE, self.texture(m.emission)
            else:
                raise TypeError(f"the reference has no material {type(m).__name__}")
        return mtype, alb, rough, inv_ior, ior, nmap

    def add(self, obj, m: np.ndarray):
        if isinstance(obj, graph.Group):
            for item in obj.items:
                self.add(item, m)
        elif isinstance(obj, graph.Transform):
            self.add(obj.obj, m @ obj.matrix)
        elif isinstance(obj, graph.Sphere):
            if not _is_uniform_similarity(m):
                raise TypeError("the reference has no ellipsoid spheres")
            c = _xform_point(m, obj.center)
            r = float(obj.radius) * float(np.linalg.norm(m[:3, 0]))
            self.spheres.append((c, r, self.material(obj.material)))
            self.prim_of[id(obj)] = (PRIM_SPHERE, len(self.spheres) - 1)
        elif isinstance(obj, graph.Plane):
            c = _xform_point(m, obj.center)
            u = _xform_vec(m, obj.u)
            v = _xform_vec(m, obj.v)
            nvec = np.cross(u, v)
            area = float(np.linalg.norm(nvec)) * 4.0
            normal = nvec / max(np.linalg.norm(nvec), 1e-30)
            du, dv = _plane_duals(u, v, normal)
            self.planes.append((c - u - v, u, v, du, dv, normal, area,
                                bool(obj.render_backface), self.material(obj.material)))
            self.prim_of[id(obj)] = (PRIM_PLANE, len(self.planes) - 1)
        elif isinstance(obj, graph.Box):
            self.add(obj.planes(), m)
        elif isinstance(obj, graph.Mesh):
            self.add_mesh(obj, m)
        elif isinstance(obj, graph.Sky):
            self.skies.append(self.texture(obj.emission))
            self.prim_of[id(obj)] = (PRIM_SKY, len(self.skies) - 1)
        elif isinstance(obj, graph.Sun):
            d = np.asarray(obj.direction, np.float64)
            self.suns.append((d / np.linalg.norm(d), self.texture(obj.emission)))
            self.prim_of[id(obj)] = (PRIM_SUN, len(self.suns) - 1)
        else:
            raise TypeError(f"the reference has no object {type(obj).__name__}")

    def add_mesh(self, mesh, m: np.ndarray):
        mat = self.material(mesh.material)
        tris = np.asarray(mesh.triangles, np.int64)
        nt = tris.shape[0]
        if nt == 0:
            return
        verts = np.asarray(mesh.vertices, np.float64) @ m[:3, :3].T + m[:3, 3]
        v0, v1, v2 = (verts[tris[:, k, 0]] for k in range(3))
        e1, e2 = v1 - v0, v2 - v0
        if mesh.flat_shading or mesh.normals.shape[0] == 0:
            face_n = np.cross(e1, e2)
            face_n /= np.maximum(np.linalg.norm(face_n, axis=-1, keepdims=True), 1e-30)
            n0 = n1 = n2 = face_n
        else:
            nrm = np.asarray(mesh.normals, np.float64) @ m[:3, :3].T
            nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-30)
            n0, n1, n2 = (nrm[tris[:, k, 1]] for k in range(3))
        if mesh.uvs.shape[0] > 0:
            uvs = np.asarray(mesh.uvs, np.float64)
            iu = np.maximum(tris[:, :, 2], 0)
            uv0, uv1, uv2 = uvs[iu[:, 0]], uvs[iu[:, 1]], uvs[iu[:, 2]]
            has_uv = tris[:, 0, 2] >= 0
        else:
            uv0 = uv1 = uv2 = np.zeros((nt, 2))
            has_uv = np.zeros((nt,), bool)
        rows = np.zeros((nt, 32), np.float64)
        for lo, col in ((0, v0), (3, e1), (6, e2), (9, n0), (12, n1), (15, n2),
                        (18, uv0), (20, uv1), (22, uv2)):
            rows[:, lo:lo + col.shape[1]] = col
        rows[:, 24] = has_uv
        rows[:, 25] = bool(mesh.hit_back_faces)
        rows[:, 26] = mat
        self.meshes.append(rows)

    def light_entry(self, obj) -> List[Tuple[int, int]]:
        if isinstance(obj, graph.Group):
            return [e for item in obj.items for e in self.light_entry(item)]
        if isinstance(obj, graph.Transform):
            return self.light_entry(obj.obj)
        kind, idx = self.prim_of[id(obj)]
        kind_map = {PRIM_SPHERE: LIGHT_SPHERE, PRIM_PLANE: LIGHT_PLANE,
                    PRIM_SKY: LIGHT_SKY, PRIM_SUN: LIGHT_SUN}
        return [(kind_map[kind], idx)] if kind in kind_map else []


def build(scene: graph.SceneDef, device) -> Scene:
    """The reference's tables of `scene` on `device`, float32."""
    fl = _Flattener()
    fl.add(scene.world, np.eye(4))
    light_list = [e for obj in scene.lights for e in fl.light_entry(obj)]
    mtype, alb, rough, inv_ior, ior, nmap = fl.material_table()

    def rows(items, k, width):
        return np.array([it[k] for it in items], np.float64).reshape(len(items), *width)

    sph, pln = fl.spheres, fl.planes
    tri_attr = (np.concatenate(fl.meshes) if fl.meshes else np.zeros((0, 32)))
    f32 = {
        "sph_center": rows(sph, 0, (3,)), "sph_radius": rows(sph, 1, ()),
        "sph_inv": np.zeros((0, 3, 3)), "sph_fwd": np.zeros((0, 3, 3)),
        "pln_corner": rows(pln, 0, (3,)), "pln_uhalf": rows(pln, 1, (3,)),
        "pln_vhalf": rows(pln, 2, (3,)), "pln_dual_u": rows(pln, 3, (3,)),
        "pln_dual_v": rows(pln, 4, (3,)), "pln_normal": rows(pln, 5, (3,)),
        "pln_area": rows(pln, 6, ()),
        "tri_attr": tri_attr,
        "sun_dir": rows(fl.suns, 0, (3,)),
        "mat_inv_ior": inv_ior, "mat_ior": ior,
        "lgt_sph_center": np.zeros((0, 3)), "lgt_sph_radius": np.zeros((0,)),
        "tex_const": np.array([n.value for n in fl.tex_nodes], np.float64),
        "background": np.asarray(scene.config.get("background", (0.0, 0.0, 0.0)), np.float64),
        "vol_axes": np.zeros((0, 3, 3)),
    }
    i32 = {
        "sph_mat": np.array([s[2] for s in sph], np.int32),
        "pln_mat": np.array([p[8] for p in pln], np.int32),
        "sky_tex": np.asarray(fl.skies, np.int32),
        "sun_tex": np.array([s[1] for s in fl.suns], np.int32),
        "mat_type": mtype, "mat_albedo_tex": alb, "mat_rough_tex": rough,
        "mat_normal_tex": nmap, "vol_kind": np.zeros((0,), np.int32),
        "vol_mat": np.zeros((0,), np.int32),
    }
    t = {k: torch.tensor(v.astype(np.float32), device=device) for k, v in f32.items()}
    t.update({k: torch.tensor(v, device=device) for k, v in i32.items()})
    t["pln_backface"] = torch.tensor(np.array([p[7] for p in pln], bool), device=device)
    t["tri_rows"] = torch.cat([t["tri_attr"][:, 0:9], t["tri_attr"][:, 25:26]], dim=1)
    return Scene(tensors=t, tex_program=tuple(fl.tex_nodes),
                 light_list=tuple(light_list))
