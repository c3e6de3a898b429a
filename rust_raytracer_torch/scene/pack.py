"""ScenePack — the flat scene as tensors on one device.

Port of rust_raytracer_tpu/scene/pack.py: the same fields (see that module
for the meaning of each table), as a NamedTuple of torch tensors, except the
reference layouts that the kernels read repacked (HOST_ONLY_FIELDS:
`bvh_rows`, `tri_geom`, `bvh8_aabb`), plus the tables the CUDA traversal
kernels read (ops/bvh8.py, ops/threaded.py; the wavefront MT kernel of
ops/wavefront.py reads `tri_rows`), derived once when the pack is built:

  bvh8_box   (n8, 8, 6) f32   child AABBs, lanes 0-5 of the reference's
                              (n8, 8, 128) `bvh8_aabb`
  tri_rows   (n_clusters * 128, 12) f32   one 48-byte row per padded
                              triangle slot: v0(0:3) e1(3:6) e2(6:9)
                              hit_back(9) 0(10:12) — rows 0-9 of the
                              reference's `tri_geom`, triangle-major
  bvh_node_rows (M, 8) f32    one 32-byte row per threaded-BVH node: the
                              content of the reference's (M, 16) `bvh_rows`
                              (node_rows below)
  bvh8_leaf_rows (n_clusters * 128, 12) f32   `tri_rows` with each
                              cluster's slots in the Morton order of their
                              centroids within the cluster's centroid
                              bounds, padding last; column 10 holds the
                              row's slot in its cluster (int32 bits)
  bvh8_leaf_box (n_clusters, 4, 6) f32   the box (lo xyz, hi xyz) of each
                              group of 32 consecutive leaf rows, from the
                              rows' float vertices, widened outward
                              (LEAF_BOX_PAD); inverted (+inf / -inf) where
                              the group holds only padding.  K1 reads these
                              two, and tests only the groups whose box a
                              ray enters
  bvh8_depth int              levels of internal BVH8 nodes on the longest
                              root-to-leaf path (bounds the kernel's stack)
  vol_kinds  tuple of int     `vol_kind` on the host: each volume's boundary
                              kind (VOL_*), so the intersector computes only
                              that kind's span without reading the device
  vol_tri_counts tuple of int each volume's rows of the padded `vol_tri_*`
                              block up to its last triangle (0 for an
                              analytic boundary); the rows past it are padding

The float DEVICE_FIELDS are the scene's parameters for the differentiable
trace (`ScenePack.with_grad`); the derived kernel tables are not: the
traversal is detached.

The wavefront pipeline reads the `wf_*` cluster and supernode tables as the
reference has them.  Material, primitive, light and volume ids are the
reference's.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

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

# Volume boundary kinds
VOL_SPHERE = 0
VOL_BOX = 1
VOL_MESH = 2

# The reference ScenePack's array fields, in its order (tex_data excluded).
LEAF_FIELDS = (
    "sph_center", "sph_radius", "sph_mat", "sph_inv", "sph_fwd",
    "pln_corner", "pln_uhalf", "pln_vhalf", "pln_dual_u", "pln_dual_v",
    "pln_normal", "pln_area", "pln_backface", "pln_mat",
    "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
    "tri_uv0", "tri_uv1", "tri_uv2", "tri_has_uv", "tri_hit_back", "tri_mat",
    "tri_attr",
    "bvh_min", "bvh_max", "bvh_hit_link", "bvh_miss_link", "bvh_leaf_start",
    "bvh_rows", "tri_geom", "bvh8_aabb", "bvh8_child",
    "wf_cl_lo", "wf_cl_hi", "wf_sn_lo", "wf_sn_hi", "wf_sn_start",
    "wf_sn_bounds",
    "vol_kind", "vol_center", "vol_radius", "vol_axes", "vol_halfsize",
    "vol_neg_inv_density", "vol_mat", "vol_tri_v0", "vol_tri_e1", "vol_tri_e2",
    "sky_tex", "sun_dir", "sun_tex",
    "mat_type", "mat_albedo_tex", "mat_rough_tex", "mat_inv_ior", "mat_ior",
    "mat_normal_tex",
    "light_kind", "light_idx", "lgt_sph_center", "lgt_sph_radius",
    "tex_const", "background",
)

# Reference layouts of the kernel tables, read only to derive the port's
# own.  They stay in compile_numpy's output (held leaf-equal to the
# reference) but are not moved to the device.
HOST_ONLY_FIELDS = ("bvh_rows", "tri_geom", "bvh8_aabb")
DEVICE_FIELDS = tuple(f for f in LEAF_FIELDS if f not in HOST_ONLY_FIELDS)

_PackBase = NamedTuple(
    "_PackBase",
    [(f, Any) for f in DEVICE_FIELDS]
    + [("tex_data", Tuple[Any, ...]), ("bvh8_box", Any), ("tri_rows", Any),
       ("bvh_node_rows", Any), ("bvh8_leaf_rows", Any), ("bvh8_leaf_box", Any),
       ("bvh8_depth", int), ("vol_kinds", Tuple[int, ...]),
       ("vol_tri_counts", Tuple[int, ...])],
)


class ScenePack(_PackBase):
    """Scene tables on one device (fields: DEVICE_FIELDS + tex_data + the
    kernel tables and the host-side counts; see the module docstring)."""

    def to(self, device) -> "ScenePack":
        moved = {f: getattr(self, f).to(device) for f in DEVICE_FIELDS}
        return self._replace(
            **moved,
            tex_data=tuple(t.to(device) for t in self.tex_data),
            bvh8_box=self.bvh8_box.to(device),
            tri_rows=self.tri_rows.to(device),
            bvh_node_rows=self.bvh_node_rows.to(device),
            bvh8_leaf_rows=self.bvh8_leaf_rows.to(device),
            bvh8_leaf_box=self.bvh8_leaf_box.to(device),
        )

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    @property
    def dtype(self) -> torch.dtype:
        """The compile dtype (scene/compiler.compile_scene): float32, or
        float64 for the validation trace."""
        return self.background.dtype

    def float_fields(self) -> Tuple[str, ...]:
        """The DEVICE_FIELDS that hold floats: the scene's parameters."""
        return tuple(f for f in DEVICE_FIELDS if getattr(self, f).is_floating_point())

    def with_grad(self) -> "ScenePack":
        """The same pack with every float DEVICE_FIELD a leaf tensor that
        requires grad (sharing storage with this pack), so that
        `torch.autograd.grad(loss, [pack.sph_center, ...])` works."""
        return self._replace(**{f: getattr(self, f).detach().requires_grad_(True)
                                for f in self.float_fields()})


def bvh8_tables(bvh8_aabb: np.ndarray, tri_geom: np.ndarray):
    """The kernel's compact tables from the reference layout:
    (n8, 8, 6) child boxes and (n_clusters * 128, 12) triangle rows."""
    box = np.ascontiguousarray(bvh8_aabb[:, :, 0:6], np.float32)
    nc, _, cl = tri_geom.shape
    rows = np.zeros((nc * cl, 12), np.float32)
    rows[:, 0:10] = tri_geom[:, 0:10, :].transpose(0, 2, 1).reshape(nc * cl, 10)
    return box, rows


# The widening of a group box (bvh8_leaf_tables): 2^-16 of a bound on the
# scene's largest coordinate (max |v0| + max |edge|), outward, then one ulp
# of the box's own float32 coordinate.  A hit that Möller–Trumbore computes
# in float32 lies within a few ulps of |ray origin - vertex| of the exact
# triangle (further for rays that graze it); a few ulps of the box alone
# would not hold every such hit inside its group's box.
LEAF_BOX_PAD = 2.0 ** -16
GROUP = 32
LEAF_CHUNK = 1024   # clusters a pass of the build: bounds its temporaries


def _spread10(device) -> torch.Tensor:
    """The 1024 10-bit ints with two zero bits after each bit (a Morton
    code's axis), on `device`."""
    bits = torch.arange(1024, dtype=torch.int64, device=device)
    table = torch.zeros_like(bits)
    for k in range(10):
        table |= ((bits >> k) & 1) << (3 * k)
    return table


def bvh8_leaf_tables(rows: torch.Tensor):
    """The leaf test's tables from the (n_clusters * 128, 12) f32 triangle
    rows, on their device (torch ops, LEAF_CHUNK clusters at a time): the
    (n_clusters * 128, 12) f32 leaf `rows`, each cluster's rows ordered by
    the 30-bit Morton code of their centroids within the cluster's own
    centroid bounds, padding slots (zero edges: never hit) last in slot
    order, with the row's slot in its cluster as int32 bits in column 10
    (zero in `rows`); and the (n_clusters, 4, 6) f32 `box` of each group of
    32 consecutive leaf rows over their float vertices v0, v0 + e1, v0 + e2
    (summed in float32, as the kernel's rows hold them), widened by
    LEAF_BOX_PAD; a group of padding alone gets lo +inf, hi -inf.  Every
    step is exact or IEEE float32, so the CPU and the card build the same
    tables."""
    nc = rows.shape[0] // 128
    leaf = torch.empty_like(rows)
    box = rows.new_empty((nc, 128 // GROUP, 6))
    if nc:
        pad = LEAF_BOX_PAD * float(rows[:, 0:3].abs().amax() + rows[:, 3:9].abs().amax())
        spread = _spread10(rows.device)
        for c in range(0, nc, LEAF_CHUNK):
            part = slice(c * 128, (c + LEAF_CHUNK) * 128)
            _leaf_chunk(rows[part], leaf[part], box[c:c + LEAF_CHUNK], pad, spread)
    return leaf, box


def _leaf_chunk(rows, leaf, box, pad: float, spread):
    """bvh8_leaf_tables of the clusters of `rows`, written into `leaf` and
    `box`."""
    n = rows.shape[0] // 128
    r = rows.view(n, 128, 12)
    inf = torch.tensor(float("inf"), dtype=rows.dtype, device=rows.device)
    real = (r[..., 3:9] != 0).any(-1)                                # (n, 128)
    cent = torch.where(real[..., None], r[..., 0:3] + (r[..., 3:6] + r[..., 6:9]) / 3.0, inf)
    c_lo = cent.amin(1, keepdim=True)
    c_hi = torch.where(real[..., None], cent, -inf).amax(1, keepdim=True)
    span = torch.where(c_hi > c_lo, c_hi - c_lo, torch.ones_like(c_hi))
    q = torch.nan_to_num((cent - c_lo) / span * 1024.0, nan=0.0).clamp(0, 1023).to(torch.int64)
    key = spread[q[..., 0]] | (spread[q[..., 1]] << 1) | (spread[q[..., 2]] << 2)
    perm = torch.sort(torch.where(real, key, 1 << 30), dim=1, stable=True).indices

    out = leaf.view(n, 128, 12)
    torch.gather(r, 1, perm[..., None].expand(-1, -1, 12), out=out)
    out.view(torch.int32)[..., 10] = perm.to(torch.int32)
    v0, a, b = out[..., 0:3], out[..., 0:3] + out[..., 3:6], out[..., 0:3] + out[..., 6:9]
    filled = torch.gather(real, 1, perm)[..., None]
    lo = torch.where(filled, torch.minimum(torch.minimum(v0, a), b), inf)
    hi = torch.where(filled, torch.maximum(torch.maximum(v0, a), b), -inf)
    g_lo = lo.view(n, 128 // GROUP, GROUP, 3).amin(2).double()      # (n, 4, 3)
    g_hi = hi.view(n, 128 // GROUP, GROUP, 3).amax(2).double()
    empty = torch.isinf(g_lo[..., 0:1])
    box[..., 0:3] = torch.where(empty, inf, torch.nextafter((g_lo - pad).float(), -inf))
    box[..., 3:6] = torch.where(empty, -inf, torch.nextafter((g_hi + pad).float(), inf))


def node_rows(bvh_min, bvh_max, hit_link, miss_link, leaf_start,
              cluster: int = 128) -> np.ndarray:
    """The threaded kernel's (M, 8) f32 node table from the threaded BVH's
    columns (ops/threaded.py): min xyz, max xyz, then two int32 stored bit
    for bit, the miss link and the hit link of an internal node or
    -(cluster + 1) of a leaf.  Raises if a leaf's hit link differs from its
    miss link, which the encoding relies on."""
    m = bvh_min.shape[0]
    leaf = np.asarray(leaf_start) >= 0
    if np.any(np.asarray(hit_link)[leaf] != np.asarray(miss_link)[leaf]):
        raise ValueError("a leaf's hit link differs from its miss link")
    rows = np.zeros((m, 8), np.float32)
    rows[:, 0:3] = bvh_min
    rows[:, 3:6] = bvh_max
    links = rows.view(np.int32)
    links[:, 6] = miss_link
    links[:, 7] = np.where(leaf, -(np.asarray(leaf_start) // cluster) - 1, hit_link)
    return rows


def bvh8_depth(child8: np.ndarray) -> int:
    """Internal-node levels on the longest root-to-leaf path of the BVH8
    (0 for an empty tree).  The traversal stack holds at most
    8 * depth + 1 entries."""
    if child8.shape[0] == 0:
        return 0
    depth = 0
    frontier = np.array([0])
    while frontier.size:
        depth += 1
        kids = child8[frontier].ravel()
        frontier = kids[kids > 0]
    return depth


def vol_tri_counts(e1: np.ndarray, e2: np.ndarray) -> Tuple[int, ...]:
    """Per volume, the rows of its (TB, 3) edge blocks up to the last row
    with a nonzero edge: padding (zero rows) is never crossed."""
    used = (e1 != 0).any(axis=-1) | (e2 != 0).any(axis=-1)
    return tuple(int(np.nonzero(u)[0][-1]) + 1 if u.any() else 0 for u in used)


def from_numpy(leaves: Dict[str, np.ndarray], tex_data: tuple, device) -> ScenePack:
    """Build the pack on `device` from numpy leaves named as the reference
    ScenePack's fields (e.g. `np.asarray` of each leaf of a JAX pack, or
    scene/compiler.compile_numpy's output) and the tex_data tuple.  The
    HOST_ONLY_FIELDS leaves are read here to derive the kernel tables and
    are not kept."""
    device = torch.device(device)
    tensors = {f: torch.tensor(np.asarray(leaves[f]), device=device)
               for f in DEVICE_FIELDS}
    box, rows = bvh8_tables(np.asarray(leaves["bvh8_aabb"]),
                            np.asarray(leaves["tri_geom"]))
    tri_rows = torch.from_numpy(rows).to(device)
    leaf_rows, leaf_box = bvh8_leaf_tables(tri_rows)
    nodes = node_rows(*(np.asarray(leaves[f]) for f in (
        "bvh_min", "bvh_max", "bvh_hit_link", "bvh_miss_link", "bvh_leaf_start")))
    return ScenePack(
        **tensors,
        tex_data=tuple(torch.tensor(np.asarray(d), device=device) for d in tex_data),
        bvh8_box=torch.from_numpy(box).to(device),
        tri_rows=tri_rows,
        bvh_node_rows=torch.from_numpy(nodes).to(device),
        bvh8_leaf_rows=leaf_rows,
        bvh8_leaf_box=leaf_box,
        bvh8_depth=bvh8_depth(np.asarray(leaves["bvh8_child"])),
        vol_kinds=tuple(int(k) for k in np.asarray(leaves["vol_kind"])),
        vol_tri_counts=vol_tri_counts(np.asarray(leaves["vol_tri_e1"]),
                                      np.asarray(leaves["vol_tri_e2"])),
    )


def empty_leaves(dtype=np.float32) -> Dict[str, np.ndarray]:
    """The numpy leaves of a scene with zero primitives of every kind (all
    tables present), with the reference's `empty_pack(dtype)` shapes and
    dtypes."""
    f, i32 = np.dtype(dtype), np.int32
    shapes = dict(
        sph_center=((0, 3), f), sph_radius=((0,), f), sph_mat=((0,), i32),
        sph_inv=((0, 3, 3), f), sph_fwd=((0, 3, 3), f),
        pln_corner=((0, 3), f), pln_uhalf=((0, 3), f), pln_vhalf=((0, 3), f),
        pln_dual_u=((0, 3), f), pln_dual_v=((0, 3), f), pln_normal=((0, 3), f),
        pln_area=((0,), f), pln_backface=((0,), bool), pln_mat=((0,), i32),
        tri_v0=((0, 3), f), tri_e1=((0, 3), f), tri_e2=((0, 3), f),
        tri_n0=((0, 3), f), tri_n1=((0, 3), f), tri_n2=((0, 3), f),
        tri_uv0=((0, 2), f), tri_uv1=((0, 2), f), tri_uv2=((0, 2), f),
        tri_has_uv=((0,), bool), tri_hit_back=((0,), bool), tri_mat=((0,), i32),
        tri_attr=((0, 32), f),
        bvh_min=((0, 3), f), bvh_max=((0, 3), f), bvh_hit_link=((0,), i32),
        bvh_miss_link=((0,), i32), bvh_leaf_start=((0,), i32),
        bvh_rows=((0, 16), np.float32), tri_geom=((0, 16, 128), np.float32),
        bvh8_aabb=((0, 8, 128), np.float32), bvh8_child=((0, 8), i32),
        wf_cl_lo=((0, 3), np.float32), wf_cl_hi=((0, 3), np.float32),
        wf_sn_lo=((0, 3), np.float32), wf_sn_hi=((0, 3), np.float32),
        wf_sn_start=((0,), i32), wf_sn_bounds=((0, 6, 128), np.float32),
        vol_kind=((0,), i32), vol_center=((0, 3), f), vol_radius=((0,), f),
        vol_axes=((0, 3, 3), f), vol_halfsize=((0, 3), f),
        vol_neg_inv_density=((0,), f), vol_mat=((0,), i32),
        vol_tri_v0=((0, 1, 3), f), vol_tri_e1=((0, 1, 3), f), vol_tri_e2=((0, 1, 3), f),
        sky_tex=((0,), i32), sun_dir=((0, 3), f), sun_tex=((0,), i32),
        mat_type=((0,), i32), mat_albedo_tex=((0,), i32), mat_rough_tex=((0,), i32),
        mat_inv_ior=((0,), f), mat_ior=((0,), f), mat_normal_tex=((0,), i32),
        light_kind=((0,), i32), light_idx=((0,), i32),
        lgt_sph_center=((0, 3), f), lgt_sph_radius=((0,), f),
        tex_const=((1, 3), f), background=((3,), f),
    )
    return {k: np.zeros(shape, dt) for k, (shape, dt) in shapes.items()}


def empty_pack(dtype=torch.float32, device="cpu") -> ScenePack:
    """A pack with zero primitives of every kind (all tables present): the
    reference's `empty_pack(dtype)` on `device`."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    return from_numpy(empty_leaves(np_dtype), (), device)
