"""Constant-density volumes in the benchmark's plain reference (reference:
object/volume.rs, material/isotropic.rs): the scene description's
`Volume` and `Isotropic`, their tables, the free flight and the hit record
of a scattering event, in plain float32 torch.

The reference's frozen modules (tables.py, hits.py) know no volume, and
the comparison (perfbench/core/check.py) calls them by name.  `install()`
makes `tables.build`, `hits.merge_volumes` and `hits.hit_attributes` the
functions below; a scene module whose scene holds a volume calls it when
it builds (perfbench/scenes/cornell_smoke.py), so importing this module
changes nothing.  Each function does what the frozen one does and, in a
scene with volumes, adds them; in a scene without, it returns what the
frozen one returns, bit for bit, so a volume-free cell's comparison is the
same whether or not a volume scene was built before it in the process.

Worked out from the scene description alone: a volume's boundary is a
`Box` under any chain of `Transform`s whose 3x3 keeps its columns
orthogonal, so the box is an oriented box in the world (its centre, the
rows of its rotation and its half-size); `-1/density` and the material
row come with it.  A sphere, mesh or sheared-box boundary raises
NotImplementedError: no cell has one.

The free flight follows volume.rs:33-71, after every surface: each volume
in turn finds its entry and exit by the slab test in its box's frame,
component by component (no matrix product), clamps the flight to
[max(t_enter, t_min, 0), min(t_exit, t_best)), draws u and scatters at
distance -log(u) / density along the unit ray if that lies inside; a
later volume's hit replaces an earlier one's (t_best shrinks as in the
reference's list scan, where a surface listed after a volume wins only if
it is nearer than the scattering point, which is the same test).

Departures from volume.rs, each shared with the program:

- entry and exit come from the slab test, not from two boundary hits
  (the second at the first's t + 1e-4); they differ only for a ray that
  grazes an edge;
- u is the pcg4d draw of stream Streams.VOLUME + 16 * vi (vi the
  volume's index), keyed by (pixel, sample, bounce, seed), in [0, 1],
  clamped to 1e-30 before the log; the reference draws from its thread's
  RNG in [0, 1);
- the distance is (-1/density) * log(u), the product volume.rs writes.

The hit record of a scattering event is volume.rs's: front face, the
arbitrary normal (1, 0, 0), the volume's material; the program flips that
normal toward the ray, which isotropic scattering ignores.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import graph
from . import hits
from . import rng
from . import tables
from . import vmath

_BUILD = tables.build
_MERGE = hits.merge_volumes
_ATTRIBUTES = hits.hit_attributes


@dataclasses.dataclass
class Isotropic(graph.Material):
    """Scatters uniformly over the sphere (material/isotropic.rs)."""
    albedo: graph.Texture


@dataclasses.dataclass
class Volume(graph.Object):
    """Constant-density medium inside `boundary` (object/volume.rs)."""
    boundary: graph.Object
    material: graph.Material
    density: float


def volume_stream(vi: int) -> int:
    """The RNG stream of volume vi's free-flight draw."""
    return rng.Streams.VOLUME + 16 * vi


def oriented_box(vol: Volume, m: np.ndarray):
    """(centre, rotation rows, half-size) in the world of `vol`'s boundary
    under the transform `m` and the boundary's own Transform chain."""
    b = vol.boundary
    while isinstance(b, graph.Transform):
        m = m @ b.matrix
        b = b.obj
    if not isinstance(b, graph.Box):
        raise NotImplementedError(f"the reference has no {type(b).__name__} volume boundary")
    a = m[:3, :3]
    norms = np.linalg.norm(a, axis=0)
    rot = a / np.maximum(norms, 1e-30)
    if not np.allclose(rot.T @ rot, np.eye(3), atol=1e-4):
        raise NotImplementedError("the reference has no sheared-box volume boundary")
    center = a @ np.asarray(b.center, np.float64) + m[:3, 3]
    half = np.asarray(b.size, np.float64) / 2.0 * norms
    return center, rot.T, half


class _Flattener(tables._Flattener):
    """The reference's flattener with volumes and isotropic materials."""

    def __init__(self):
        super().__init__()
        self.volumes = []   # (centre, rotation rows, half-size, -1/density, material)

    def add(self, obj, m: np.ndarray):
        if isinstance(obj, Volume):
            self.volumes.append((*oriented_box(obj, m), -1.0 / float(obj.density),
                                 self.material(obj.material)))
        else:
            super().add(obj, m)

    def material_table(self):
        """The table with each Isotropic row as MAT_ISOTROPIC with its albedo
        (registered where a Lambertian's would be)."""
        kept = self.materials
        iso = [i for i, m in enumerate(kept) if isinstance(m, Isotropic)]
        self.materials = [graph.Lambertian(m.albedo) if isinstance(m, Isotropic) else m
                          for m in kept]
        try:
            mtype, *rest = super().material_table()
        finally:
            self.materials = kept
        mtype[iso] = tables.MAT_ISOTROPIC
        return (mtype, *rest)


def _holds_volume(obj) -> bool:
    if isinstance(obj, graph.Group):
        return any(_holds_volume(item) for item in obj.items)
    if isinstance(obj, graph.Transform):
        return _holds_volume(obj.obj)
    return isinstance(obj, Volume)


def build(scene: graph.SceneDef, device) -> tables.Scene:
    """`tables.build` with the volumes' tables: `vol_center` (V, 3),
    `vol_axes` (V, 3, 3) rotation rows, `vol_halfsize` (V, 3),
    `vol_neg_inv_density` (V,), `vol_mat` (V,), `vol_kind` (V,) zeros;
    without a volume, `tables.build`'s own scene."""
    if not _holds_volume(scene.world):
        return _BUILD(scene, device)
    made = []

    class Recording(_Flattener):
        def __init__(self):
            super().__init__()
            made.append(self)

    base, tables._Flattener = tables._Flattener, Recording
    try:
        out = _BUILD(scene, device)
    finally:
        tables._Flattener = base
    vols = made[0].volumes
    nv = len(vols)

    def f32(k, shape):
        rows = np.array([v[k] for v in vols], np.float64).reshape(nv, *shape)
        return torch.tensor(rows.astype(np.float32), device=device)

    return out.with_tables(
        vol_center=f32(0, (3,)), vol_axes=f32(1, (3, 3)), vol_halfsize=f32(2, (3,)),
        vol_neg_inv_density=f32(3, ()),
        vol_mat=torch.tensor(np.array([v[4] for v in vols], np.int32), device=device),
        vol_kind=torch.zeros((nv,), dtype=torch.int32, device=device))


def n_volumes(scene) -> int:
    center = getattr(scene, "vol_center", None)
    return 0 if center is None else int(center.shape[0])


def slab_span(scene, vi: int, org, dirn):
    """(t_enter, t_exit, valid) of each ray against volume vi's box: the
    slab test in the box's frame, one axis at a time, NaN-propagating
    min and max."""
    c, r, h = scene.vol_center[vi], scene.vol_axes[vi], scene.vol_halfsize[vi]
    ox, oy, oz = org[:, 0] - c[0], org[:, 1] - c[1], org[:, 2] - c[2]
    enter = leave = None
    for k in range(3):
        o_k = ox * r[k, 0] + oy * r[k, 1] + oz * r[k, 2]
        d_k = dirn[:, 0] * r[k, 0] + dirn[:, 1] * r[k, 1] + dirn[:, 2] * r[k, 2]
        inv = 1.0 / d_k
        t0 = (-h[k] - o_k) * inv
        t1 = (h[k] - o_k) * inv
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        enter = near if enter is None else torch.maximum(enter, near)
        leave = far if leave is None else torch.minimum(leave, far)
    return enter, leave, enter < leave


def free_flight(scene, org, dirn, t_min, t_best, rng_ctx):
    """(t, volume id or -1) of each ray's scattering event, the flights
    truncated at `t_best` (the nearest surface, then each earlier
    volume's hit)."""
    ray_len = vmath.length(dirn)
    best_i = torch.full((org.shape[0],), -1, dtype=torch.int32, device=org.device)
    for vi in range(n_volumes(scene)):
        t_enter, t_exit, valid = slab_span(scene, vi, org, dirn)
        lo = torch.clamp(torch.maximum(t_enter, t_min), min=0.0)
        hi = torch.minimum(t_exit, t_best)
        inside = valid & (lo < hi)
        dist_inside = (hi - lo) * ray_len
        u = rng_ctx.uniform(volume_stream(vi))
        hit_dist = scene.vol_neg_inv_density[vi] * torch.log(torch.clamp(u, min=1e-30))
        hit = inside & (hit_dist <= dist_inside)
        best_i = torch.where(hit, vi, best_i)
        t_best = torch.where(hit, lo + hit_dist / ray_len, t_best)
    return t_best, best_i


def merge_volumes(pack, org, dirn, t_min, rng_ctx, t_sph, i_sph, t_pln, i_pln, t_tri, i_tri,
                  inf=None):
    """`hits.merge_volumes` (the closest surface), then the free flight."""
    t_best, kind, prim = _MERGE(pack, org, dirn, t_min, rng_ctx, t_sph, i_sph, t_pln, i_pln,
                                t_tri, i_tri, inf)
    if not n_volumes(pack):
        return t_best, kind, prim
    if not isinstance(t_min, torch.Tensor):
        t_min = torch.full(t_best.shape, t_min, dtype=org.dtype, device=org.device)
    t_vol, i_vol = free_flight(pack, org, dirn, t_min, t_best, rng_ctx)
    vol_hit = i_vol >= 0
    return (torch.where(vol_hit, t_vol, t_best),
            torch.where(vol_hit, tables.PRIM_VOLUME, kind).to(torch.int32),
            torch.where(vol_hit, i_vol, prim).to(torch.int32))


def hit_attributes(pack, org, dirn, hit: hits.Hit) -> hits.HitAttributes:
    """`hits.hit_attributes`, with a scattering event's record as
    volume.rs:56-66 makes it: front face, normal (1, 0, 0), the volume's
    material (the position is the ray's at the event's t, as there)."""
    attr = _ATTRIBUTES(pack, org, dirn, hit)
    nv = n_volumes(pack)
    if not nv:
        return attr
    is_v = hit.kind == tables.PRIM_VOLUME
    x_axis = vmath.const3((1.0, 0.0, 0.0), org.dtype, org.device)
    prim = torch.clamp(hit.prim, min=0, max=nv - 1).to(torch.int64)
    return attr._replace(normal=torch.where(is_v[:, None], x_axis, attr.normal),
                         front_face=attr.front_face | is_v,
                         mat=torch.where(is_v, pack.vol_mat[prim], attr.mat))


def install():
    """Route the reference's `tables.build`, `hits.merge_volumes` and
    `hits.hit_attributes` through this module's (the same results in a
    scene without volumes); calling it again changes nothing."""
    tables.build = build
    hits.merge_volumes = merge_volumes
    hits.hit_attributes = hit_attributes
