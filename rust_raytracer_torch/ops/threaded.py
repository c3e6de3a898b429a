"""Closest-hit triangle traversal of the threaded binary BVH (K3): the CUDA
kernel and its plain PyTorch version.

`intersect_triangles_threaded` replaces the reference's Pallas kernel
(rust_raytracer_tpu/ops/pallas_intersect.py:_kernel).  On a CUDA tensor it
launches the hand-written kernel in csrc/threaded_traverse.cu (built with
nvcc at first use into build/rrt_torch/ by ops/_cuda.py); on a CPU tensor
it runs `traverse_plain`.  There is no fallback between the two: a CUDA
input that cannot launch raises.

Contract (every traversal kernel's): rays org/dirn (N, 3) f32 and t_max
(N,) f32 in; (t, slot) out, where slot = cluster * 128 + lane indexes the
padded triangle table and t == t_max where nothing was hit.  t_min is fixed
at T_MIN_STATIC = 1e-3 (the caller's t_min is ignored, as in the reference).

`traverse_plain` ports the reference's own oracle, the threaded-BVH walk of
ops/intersect.py (kernel="jnp"), and is the plain version of every exact
traversal: of this kernel and of the BVH8 kernel (ops/bvh8.py).  It clamps
the slab's near distance at T_MIN_STATIC, as the oracle and the kernel do
(the reference's Pallas kernel does not; a box whose far distance is below
T_MIN_STATIC holds only hits that Möller–Trumbore rejects, so that changes
which leaves are visited, never the result).  The kernel visits the nodes
of each ray in the plain version's order, so its (t, slot) equal the plain
version's, ties included, and the plain walk's counts are the kernel's.

The kernel reads the node table `bvh_node_rows` (M, 8) f32, one 32-byte row
a node (scene/pack.py:node_rows): min xyz, max xyz, then two int32 stored bit for
bit: the miss link, and the hit link for an internal node or -(cluster + 1)
for a leaf (a leaf's hit link equals its miss link in the threaded
preorder, scene/bvh_builder.py).
"""
from __future__ import annotations

import torch

from . import _cuda

CLUSTER = 128
DET_EPS = 1e-12
T_MIN_STATIC = 1e-3  # reference: camera.rs:294 interval lower bound

# Launch counters: `launches` counts CUDA kernel launches, `plain_calls`
# calls of the plain version through the wrapper.
launches = 0
plain_calls = 0


def check_rays(org, dirn, t_max):
    n = org.shape[0]
    for name, a, shape in (("org", org, (n, 3)), ("dirn", dirn, (n, 3)),
                           ("t_max", t_max, (n,))):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(a.shape)}")
        if a.device != org.device:
            raise ValueError(f"{name} is on {a.device}, org on {org.device}")


def _launch(pack, org, dirn, t_max):
    global launches
    tables = (pack.bvh_node_rows, pack.tri_rows)
    for a in (*tables, org, dirn, t_max):
        if not a.is_contiguous():
            raise ValueError("the threaded kernel takes contiguous tensors only")
        if a.device != org.device:
            raise ValueError(f"scene tables on {a.device}, rays on {org.device}")
    if tuple(pack.bvh_node_rows.shape[1:]) != (8,) or pack.bvh_node_rows.dtype != torch.float32:
        raise TypeError("bvh_node_rows must be (M, 8) float32")
    n = org.shape[0]
    t_out = torch.empty((n,), dtype=torch.float32, device=org.device)
    slot = torch.empty((n,), dtype=torch.int32, device=org.device)
    if n == 0:
        return t_out, slot
    _cuda.launch("rrt_threaded_traverse", (*tables, org, dirn, t_max, t_out, slot),
                 (n, pack.bvh_node_rows.shape[0]), org.device)
    launches += 1
    return t_out, slot


def intersect_triangles_threaded(pack, org, dirn, t_min, t_max):
    """Closest triangle hit through the threaded BVH (see the module
    docstring).  CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    global plain_calls
    del t_min  # static T_MIN_STATIC, as in the reference kernel
    check_rays(org, dirn, t_max)
    n = org.shape[0]
    if pack.bvh_node_rows.shape[0] == 0 or pack.tri_rows.shape[0] == 0:
        return t_max, torch.full((n,), -1, dtype=torch.int32, device=org.device)
    if org.device.type == "cuda":
        return _launch(pack, org, dirn, t_max)
    if org.device.type != "cpu":
        raise ValueError(f"no threaded traversal for device {org.device}")
    plain_calls += 1
    return traverse_plain(pack, org, dirn, t_max)


def mt_rows(o, d, rows, best, t_min=T_MIN_STATIC):
    """Möller–Trumbore of rays (L, 1) against triangle rows (L, K, >= 10) in
    the reference kernel's operation order; returns (L, K) t with +inf
    where a triangle is rejected (including t <= t_min and t >= best)."""
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = rows[..., 0], rows[..., 1], rows[..., 2]
    e1x, e1y, e1z = rows[..., 3], rows[..., 4], rows[..., 5]
    e2x, e2y, e2z = rows[..., 6], rows[..., 7], rows[..., 8]
    back = rows[..., 9]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    dd = torch.where(back > 0.5, torch.abs(det), det)
    ok = dd > DET_EPS
    inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    bx = o[:, 0:1] - v0x
    by = o[:, 1:2] - v0y
    bz = o[:, 2:3] - v0z
    u = (bx * px + by * py + bz * pz) * inv_det
    qx = by * e1z - bz * e1y
    qy = bz * e1x - bx * e1z
    qz = bx * e1y - by * e1x
    w = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0) & (w >= 0.0) & (u + w <= 1.0)
    ok &= (t > t_min) & (t < best[:, None])
    return torch.where(ok, t, torch.full_like(t, float("inf")))


def warps_of(lanes):
    """The number of distinct warps (32 lanes in ray order) among the
    sorted lane ids `lanes`, as a 0-d tensor."""
    w = lanes // 32
    return (w[1:] != w[:-1]).sum() + int(w.numel() > 0)


# leaf lanes tested per block in the plain version: bounds the (L, 128, 12)
# gathered triangle rows at ~400 MB
_LEAF_BLOCK = 1 << 16


def traverse_plain(pack, org, dirn, t_max, counts=None, rows=None, t_min=T_MIN_STATIC):
    """Plain PyTorch version of the exact traversals: the reference's
    threaded-BVH walk (ops/intersect.py:436-497), every active lane
    advancing one node per step, with the kernels' contract (static t_min,
    t == t_max on a miss, slot ids into the padded triangle table).
    `rows` (n_slots, >= 10), the triangle rows tested (v0, e1, e2,
    hit_back), default the f32 `tri_rows`; ops/intersect.py's "jnp" walk
    passes them in the pack's dtype, with its own `t_min`.

    Within a leaf the lowest slot wins at equal t; across leaves a later
    leaf must be strictly closer — the reference's sequential `t < best`.

    `counts`, a dict if given, receives what the walk did: "node_visits"
    (slab tests), "leaf_visits" (clusters tested), "nodes" and "clusters"
    (distinct ones touched), and for warps of 32 lanes in ray order, as the
    kernel runs them, "warp_steps" (the warps' walk-loop iterations: per
    step, the warps with a lane still walking) and "warp_leaf_passes" (per
    step, the warps with a lane at a leaf), as Python ints.
    """
    n = org.shape[0]
    dev = org.device
    best_t = t_max.clone()
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    n_nodes = pack.bvh_min.shape[0]
    if n_nodes == 0 or pack.tri_rows.shape[0] == 0:
        return best_t, best_i

    inv = 1.0 / dirn
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    bmin_t, bmax_t = pack.bvh_min, pack.bvh_max
    hit_link = pack.bvh_hit_link.to(torch.int64)
    miss_link = pack.bvh_miss_link.to(torch.int64)
    leaf_start = pack.bvh_leaf_start.to(torch.int64)
    rows = pack.tri_rows if rows is None else rows
    rows = rows.view(-1, CLUSTER, rows.shape[1])
    k_idx = torch.arange(CLUSTER, device=dev)
    if counts is not None:
        visits = torch.zeros((), dtype=torch.int64, device=dev)
        leaves = torch.zeros((), dtype=torch.int64, device=dev)
        warp_steps = torch.zeros((), dtype=torch.int64, device=dev)
        leaf_passes = torch.zeros((), dtype=torch.int64, device=dev)
        touched = torch.zeros((n_nodes,), dtype=torch.bool, device=dev)
        touched_leaf = torch.zeros((n_nodes,), dtype=torch.bool, device=dev)

    while lanes.numel():
        nd = node[lanes]
        o, iv, bt = org[lanes], inv[lanes], best_t[lanes]
        t0 = (bmin_t[nd] - o) * iv
        t1 = (bmax_t[nd] - o) * iv
        near = torch.minimum(t0, t1)
        far = torch.maximum(t0, t1)
        t_near = torch.maximum(
            torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2]),
            torch.full_like(bt, t_min))
        t_far = torch.minimum(
            torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2]), bt)
        box_hit = t_near <= t_far
        ls = leaf_start[nd]
        is_leaf = box_hit & (ls >= 0)

        leaf_sel = torch.nonzero(is_leaf).squeeze(1)
        for s in range(0, leaf_sel.numel(), _LEAF_BLOCK):
            sel = leaf_sel[s:s + _LEAF_BLOCK]
            ln = lanes[sel]
            start = ls[sel]
            tt = mt_rows(org[ln], dirn[ln], rows[start // CLUSTER], best_t[ln], t_min)
            tmin = tt.min(dim=1).values
            first = torch.where(tt == tmin[:, None], k_idx, CLUSTER).min(dim=1).values
            better = tmin < best_t[ln]
            best_t[ln] = torch.where(better, tmin, best_t[ln])
            best_i[ln] = torch.where(better, (start + first).to(torch.int32), best_i[ln])
        if counts is not None:
            visits += nd.numel()
            leaves += leaf_sel.numel()
            warp_steps += warps_of(lanes)
            leaf_passes += warps_of(lanes[leaf_sel])
            touched[nd] = True
            touched_leaf[nd[leaf_sel]] = True

        nxt = torch.where(box_hit & (ls < 0), hit_link[nd], miss_link[nd])
        node[lanes] = nxt
        lanes = lanes[nxt < n_nodes]
    if counts is not None:
        counts.update(node_visits=int(visits), leaf_visits=int(leaves),
                      nodes=int(touched.sum()), clusters=int(touched_leaf.sum()),
                      warp_steps=int(warp_steps), warp_leaf_passes=int(leaf_passes))
    return best_t, best_i
