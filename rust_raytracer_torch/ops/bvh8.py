"""Closest-hit triangle traversal of the BVH8: the CUDA kernel and its plain
PyTorch version.

`intersect_triangles_bvh8` replaces the reference's Pallas kernel
(rust_raytracer_tpu/ops/pallas_bvh8.py).  On a CUDA tensor it launches the
hand-written kernel in csrc/bvh8_traverse.cu (built with nvcc at first use
into build/rrt_torch/ by ops/_cuda.py); on a CPU tensor it runs
`traverse_plain`.  There is no fallback between the two: a CUDA input that
cannot launch raises.

Contract (the reference kernel's): rays org/dirn (N, 3) f32 and t_max (N,)
f32 in; (t, slot) out, where slot = cluster * 128 + lane indexes the padded
triangle table and t == t_max where nothing was hit.  t_min is fixed at
T_MIN_STATIC = 1e-3 (the caller's t_min is ignored, as in the reference).

Its plain version is `traverse_plain` of ops/threaded.py, the port's one
threaded-BVH walk (the reference's oracle, ops/intersect.py kernel="jnp"),
with the same contract: the BVH8 walk visits leaves in another order, so
only the slot of an equal-t tie may differ from it.

The kernel reads the triangle rows as the pack's `bvh8_leaf_rows` (each
cluster's rows in Morton order, each with its slot) and tests at a leaf
visit only the groups of 32 of them whose box (`bvh8_leaf_box`) the ray
enters; `leaf_test_plain` is that test in torch ops, equal to the full
128-slot scan.  An optional (2,) int64 `counts` adds the leaf visits and
the groups tested.
"""
from __future__ import annotations

import torch

from ..scene.pack import GROUP
from . import _cuda
from ._cuda import build_library  # noqa: F401 (re-exported: chip_smoke.py builds through it)
from .threaded import T_MIN_STATIC, check_rays, mt_rows, traverse_plain

CLUSTER = 128
STACK = 160          # must match csrc/bvh8_traverse.cu

# Launch counters: `launches` counts CUDA kernel launches, `plain_calls`
# calls of the plain version through the wrapper.
launches = 0
plain_calls = 0


def fits(pack) -> bool:
    """Whether the BVH8 kernel can run this scene: it has a BVH8 and the
    walk's stack (at most 8 * depth + 1 entries) fits in STACK.  The
    counterpart of the reference's `_fits_vmem` (ops/intersect.py:350)."""
    return pack.bvh8_child.shape[0] > 0 and 8 * pack.bvh8_depth + 1 <= STACK


def _launch(pack, org, dirn, t_max, counts):
    global launches
    if not fits(pack):
        raise ValueError(
            f"BVH8 depth {pack.bvh8_depth} needs a traversal stack of "
            f"{8 * pack.bvh8_depth + 1} entries; the kernel has {STACK}")
    tables = (pack.bvh8_box, pack.bvh8_child, pack.bvh8_leaf_rows, pack.bvh8_leaf_box)
    for a in (*tables, org, dirn, t_max) + (() if counts is None else (counts,)):
        if not a.is_contiguous():
            raise ValueError("the BVH8 kernel takes contiguous tensors only")
        if a.device != org.device:
            raise ValueError(f"scene tables on {a.device}, rays on {org.device}")
    if pack.bvh8_child.dtype != torch.int32:
        raise TypeError("bvh8_child must be int32")
    n_cl = pack.tri_rows.shape[0] // CLUSTER
    if (pack.bvh8_leaf_rows.dtype != torch.float32
            or tuple(pack.bvh8_leaf_rows.shape) != tuple(pack.tri_rows.shape)
            or pack.bvh8_leaf_box.dtype != torch.float32
            or tuple(pack.bvh8_leaf_box.shape) != (n_cl, CLUSTER // GROUP, 6)):
        raise TypeError("bvh8_leaf_rows must be float32 shaped as tri_rows and "
                        "bvh8_leaf_box (n_clusters, 4, 6) float32")
    if pack.bvh8_leaf_rows.data_ptr() % 16:
        raise ValueError("bvh8_leaf_rows is read as float4: it must be 16-byte aligned")
    if counts is not None and (counts.dtype != torch.int64 or tuple(counts.shape) != (2,)):
        raise TypeError("counts must be a (2,) int64 tensor")
    n = org.shape[0]
    t_out = torch.empty((n,), dtype=torch.float32, device=org.device)
    slot = torch.empty((n,), dtype=torch.int32, device=org.device)
    if n == 0:
        return t_out, slot
    _cuda.launch("rrt_bvh8_traverse", (*tables, org, dirn, t_max, t_out, slot, counts),
                 (n,), org.device)
    launches += 1
    return t_out, slot


def intersect_triangles_bvh8(pack, org, dirn, t_min, t_max, counts=None):
    """Closest triangle hit through the BVH8 (see the module docstring).
    CUDA tensors launch the kernel, which adds its leaf visits and groups
    tested to `counts` ((2,) int64 on the rays' device) if given; CPU
    tensors run the plain version, which counts nothing."""
    global plain_calls
    del t_min  # static T_MIN_STATIC, as in the reference kernel
    check_rays(org, dirn, t_max)
    n = org.shape[0]
    if pack.bvh8_child.shape[0] == 0 or pack.tri_rows.shape[0] == 0:
        return t_max, torch.full((n,), -1, dtype=torch.int32, device=org.device)
    if org.device.type == "cuda":
        return _launch(pack, org, dirn, t_max, counts)
    if org.device.type != "cpu":
        raise ValueError(f"no BVH8 traversal for device {org.device}")
    plain_calls += 1
    return traverse_plain(pack, org, dirn, t_max)


def leaf_test_plain(pack, org, dirn, best, cl):
    """K1's leaf test in torch ops (csrc/bvh8_traverse.cu:warp_leaf_test):
    rays org, dirn (L, 3) with their best t (L,) (t_max clamped at 3.4e38)
    at clusters `cl` (L,).  Each group of 32 leaf rows is tested only
    where the ray enters its box (the node test's slab, near clamped at
    T_MIN, far at best; an inverted box is empty).  Returns (t, slot,
    groups): the least t < best over the tested rows (+inf if none), the
    lowest slot of the cluster at that t (a row's slot is its column 10),
    and the groups tested a ray.  The boxes hold every triangle, so (t,
    slot) equal the full scan's: mt_rows over the cluster's 128 rows of
    `tri_rows`, then the first slot at their minimum."""
    box = pack.bvh8_leaf_box[cl]                                   # (L, 4, 6)
    rows = pack.bvh8_leaf_rows.view(-1, CLUSTER, 12)[cl]           # (L, 128, 12)
    slots = rows[..., 10].contiguous().view(torch.int32).to(torch.int64)
    o, iv = org[:, None], (1.0 / dirn)[:, None]
    t0 = (box[..., 0:3] - o) * iv
    t1 = (box[..., 3:6] - o) * iv
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    t_min = torch.tensor(T_MIN_STATIC, dtype=org.dtype, device=org.device)
    near = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), torch.maximum(lo[..., 2], t_min))
    far = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]),
                        torch.minimum(hi[..., 2], best[:, None]))
    enter = (box[..., 0] <= box[..., 3]) & (near <= far)           # (L, 4)
    tt = mt_rows(org, dirn, rows, best)
    tt = torch.where(enter.repeat_interleave(GROUP, dim=1), tt, torch.full_like(tt, float("inf")))
    t = tt.min(dim=1).values
    slot = torch.where(tt == t[:, None], slots, CLUSTER).min(dim=1).values
    return t, slot, enter.sum(dim=1)
