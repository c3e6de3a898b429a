"""Host-side scene graph.

Mirrors the reference's constructor surface (textures: src/texture/*,
materials: src/material/*, objects: src/object/*) as plain Python dataclasses
built from NumPy data.  The graph is *description only*: scene/compiler.py
flattens it into a device-resident `ScenePack` (transforms baked, meshes
merged into one triangle soup + flat BVH, texture DAG compiled to a static
program).  Nothing here ever runs per-ray.

The port's copy of rust_raytracer_tpu/scene/graph.py, held equal to it by
tests/test_torch_scene.py (both packages compile the same scenes to equal
tables).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# Noise generators (reference: src/noise/perlin.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Perlin:
    """Perlin noise tables: 256 random unit gradients + 3 permutations
    (reference: perlin.rs:19-52).  Seeded for reproducibility (the reference
    seeds from thread_rng)."""
    seed: int = 0

    def tables(self):
        rng = np.random.default_rng(self.seed)
        g = rng.normal(size=(256, 3))
        g /= np.linalg.norm(g, axis=-1, keepdims=True)
        perms = [rng.permutation(256).astype(np.int32) for _ in range(3)]
        return g.astype(np.float32), perms[0], perms[1], perms[2]


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


@dataclasses.dataclass
class CheckerSolid(Texture):
    """World-space checkerboard (texture/checkerboard.rs:74-85)."""
    even: Texture
    odd: Texture
    scale: float = 1.0

    @property
    def is_scalar(self):
        return self.even.is_scalar


@dataclasses.dataclass
class Image(Texture):
    """Image texture, nearest-neighbor (texture/image.rs).  `pixels` is
    (H, W, 3) float32 linear RGB."""
    pixels: np.ndarray
    clamp: bool = False  # False = Repeat (the reference default)

    @staticmethod
    def from_file(path: str) -> "Image":
        from PIL import Image as PILImage

        img = PILImage.open(path).convert("RGB")
        arr = np.asarray(img, np.float32) / 255.0
        return Image(pixels=arr)


@dataclasses.dataclass
class Lerp(Texture):
    """Interpolate two textures by a scalar third (texture/interpolate.rs)."""
    a: Texture
    b: Texture
    t: Texture

    @property
    def is_scalar(self):
        return self.a.is_scalar


@dataclasses.dataclass
class NoiseSolid(Texture):
    """Turbulence noise with post-map (texture/noise.rs).  map: "marble"
    (default 0.5*(1+sin(z + 10*turb))) or "turbulence" (raw)."""
    noise: Perlin
    scale: float = 1.0
    samples: int = 7
    map: str = "marble"
    is_scalar = True


@dataclasses.dataclass
class Channel(Texture):
    """Extract one channel of a color texture as scalar (texture/channel.rs)."""
    source: Texture
    channel: int = 0
    is_scalar = True


@dataclasses.dataclass
class UvDebug(Texture):
    """(u, v, 0.5) debug color (texture/uv_debug.rs)."""
    pass


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


@dataclasses.dataclass
class Isotropic(Material):
    albedo: Texture


@dataclasses.dataclass
class NormalDebug(Material):
    normal_map: Optional[Texture] = None


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
class Volume(Object):
    """Constant-density medium in a convex boundary (reference:
    object/volume.rs).  Boundary must compile to a sphere or box."""
    boundary: Object
    material: Material
    density: float


@dataclasses.dataclass
class ProxySphereLight(Object):
    """Invisible sphere used ONLY for NEE light sampling — never hit by
    rays.  The reference's Assimp loader adds one per emissive mesh so
    arbitrary emissive geometry can be importance-sampled
    (assimp.rs:123-129: 'Create an invisible sphere object to sample
    lighting').  Belongs in SceneDef.lights, not in the world."""
    center: Sequence[float]
    radius: float


@dataclasses.dataclass
class SceneDef:
    """(camera config, world, lights) — reference SceneData (scene.rs:30)."""
    world: Object
    lights: List[Object]
    config: dict = dataclasses.field(default_factory=dict)
