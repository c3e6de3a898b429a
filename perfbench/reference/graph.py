"""Host-side scene description of the benchmark's plain reference.

A frozen copy of the same-named plain module of rust_raytracer_torch, kept
here so the reference imports nothing of the program it judges.  Do not
change it to follow the program: a change of the program's arithmetic is
what the comparison exists to catch.

Mirrors the reference's constructor surface (textures: src/texture/*,
materials: src/material/*, objects: src/object/*) as plain Python dataclasses
built from NumPy data.  The graph is *description only*: scene/compiler.py
flattens it into a device-resident `ScenePack` (transforms baked, meshes
merged into one triangle soup + flat BVH, texture DAG compiled to a static
program).  Nothing here ever runs per-ray.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# Textures (reference: src/texture/*)
# ---------------------------------------------------------------------------


class Texture:
    is_scalar = False


@dataclasses.dataclass
class Constant(Texture):
    """Constant color or scalar (texture/constant.rs)."""
    value: Union[float, Tuple[float, float, float], Sequence[float]]

    @property
    def is_scalar(self):
        return np.isscalar(self.value)

    def vec3(self):
        if np.isscalar(self.value):
            v = float(self.value)
            return (v, v, v)
        v = tuple(float(x) for x in self.value)
        assert len(v) == 3
        return v


@dataclasses.dataclass
class Checker(Texture):
    """UV-space checkerboard (texture/checkerboard.rs:34-44)."""
    even: Texture
    odd: Texture
    scale: float = 1.0

    @property
    def is_scalar(self):
        return self.even.is_scalar


def as_texture(x) -> Texture:
    """Coerce scalars / 3-sequences to Constant textures."""
    if isinstance(x, Texture):
        return x
    return Constant(x)


# ---------------------------------------------------------------------------
# Materials (reference: src/material/*)
# ---------------------------------------------------------------------------


class Material:
    pass


@dataclasses.dataclass
class Lambertian(Material):
    albedo: Texture


@dataclasses.dataclass
class Metal(Material):
    albedo: Texture
    roughness: Texture


@dataclasses.dataclass
class Dielectric(Material):
    ior: float = 1.5


@dataclasses.dataclass
class Glossy(Material):
    albedo: Texture
    roughness: Texture
    ior: float = 1.5
    normal_map: Optional[Texture] = None


@dataclasses.dataclass
class Emissive(Material):
    emission: Texture


# ---------------------------------------------------------------------------
# Objects (reference: src/object/*)
# ---------------------------------------------------------------------------


class Object:
    pass


@dataclasses.dataclass
class Sphere(Object):
    center: Sequence[float]
    radius: float
    material: Material


@dataclasses.dataclass
class Plane(Object):
    """Finite parallelogram: center + half-span vectors u, v
    (reference: plane.rs:28-63; u ⟂ v required)."""
    center: Sequence[float]
    u: Sequence[float]
    v: Sequence[float]
    material: Material
    render_backface: bool = False

    def __post_init__(self):
        if abs(float(np.dot(self.u, self.v))) > 1e-9 * (
            np.linalg.norm(self.u) * np.linalg.norm(self.v) + 1e-30
        ):
            raise ValueError("The UV vectors must be orthogonal!")


@dataclasses.dataclass
class Box(Object):
    """Axis-aligned box (reference: object/obj_box.rs `make_box`).

    Compiles to six outward-facing planes when placed in the world; when used
    as a Volume boundary it compiles to an analytic (oriented) box instead.
    """
    center: Sequence[float]
    size: Sequence[float]
    material: Material

    def planes(self) -> "Group":
        return make_box(self.center, self.size, self.material)


def make_box(center, size, material) -> "Group":
    """Six outward-facing planes (reference: object/obj_box.rs:8-48)."""
    c = np.asarray(center, np.float64)
    half = np.asarray(size, np.float64) / 2.0
    dx = np.array([half[0], 0, 0])
    dy = np.array([0, half[1], 0])
    dz = np.array([0, 0, half[2]])
    sides = [
        Plane(c + dy, dx, -dz, material),
        Plane(c - dy, -dx, -dz, material),
        Plane(c - dx, dz, dy, material),
        Plane(c + dx, -dz, dy, material),
        Plane(c - dz, -dx, dy, material),
        Plane(c + dz, dx, dy, material),
    ]
    return Group(sides)


@dataclasses.dataclass
class Mesh(Object):
    """Indexed triangle mesh (reference: object/mesh.rs:15-59).

    `triangles` is (T, 3, 3) int32: per-corner (vertex, normal, uv) index
    triples; uv index -1 means no UVs for that triangle.
    """
    vertices: np.ndarray        # (V, 3) f64
    normals: np.ndarray         # (Nn, 3)
    uvs: np.ndarray             # (Nu, 2)
    triangles: np.ndarray       # (T, 3, 3) int32
    material: Material
    flat_shading: bool = False
    hit_back_faces: bool = False


@dataclasses.dataclass
class Transform(Object):
    """Instance wrapper (reference: object/transform.rs).  `matrix` is the
    4x4 forward transform; built incrementally via the helpers below."""
    obj: Object
    matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float64)
    )

    def _apply(self, m):
        # incremental composition matches transform.rs:44-96: each call
        # left-multiplies the accumulated matrix
        self.matrix = m @ self.matrix
        return self

    def translate(self, x, y, z):
        m = np.eye(4)
        m[:3, 3] = [x, y, z]
        return self._apply(m)

    def scale(self, x, y=None, z=None):
        if y is None:
            y = z = x
        m = np.diag([x, y, z, 1.0])
        return self._apply(m)

    def rotate_x(self, deg):
        a = np.deg2rad(deg)
        m = np.eye(4)
        m[1, 1] = np.cos(a); m[1, 2] = -np.sin(a)
        m[2, 1] = np.sin(a); m[2, 2] = np.cos(a)
        return self._apply(m)

    def rotate_y(self, deg):
        a = np.deg2rad(deg)
        m = np.eye(4)
        m[0, 0] = np.cos(a); m[0, 2] = np.sin(a)
        m[2, 0] = -np.sin(a); m[2, 2] = np.cos(a)
        return self._apply(m)

    def rotate_z(self, deg):
        a = np.deg2rad(deg)
        m = np.eye(4)
        m[0, 0] = np.cos(a); m[0, 1] = -np.sin(a)
        m[1, 0] = np.sin(a); m[1, 1] = np.cos(a)
        return self._apply(m)


@dataclasses.dataclass
class Group(Object):
    """ObjectList / BVH container (reference: object/list.rs, object/bvh.rs).

    Acceleration is automatic in the compiler, so `list` and `bvh` compile
    identically; the flag is kept for DSL round-tripping."""
    items: List[Object]
    bvh: bool = False


@dataclasses.dataclass
class Sky(Object):
    """Environment sphere at infinity (reference: object/sky.rs)."""
    emission: Texture


@dataclasses.dataclass
class Sun(Object):
    """Delta directional light (reference: object/sun.rs)."""
    direction: Sequence[float]
    emission: Texture


@dataclasses.dataclass
class SceneDef:
    """(camera config, world, lights) — reference SceneData (scene.rs:30)."""
    world: Object
    lights: List[Object]
    config: dict = dataclasses.field(default_factory=dict)
