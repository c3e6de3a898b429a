"""Host-side flat threaded BVH builder.

Replaces the reference's pointer-based per-mesh octree (octree.rs) and scene
BVH (bvh.rs) with ONE flat BVH over all world-space triangles, laid out in
DFS (preorder) order with hit/miss skip links for stackless traversal
(ops/intersect.py).  Closest-hit semantics are order-independent, so the
octree-with-duplicates -> single-BVH swap is behavior-preserving (only perf
differs).

Construction is fully vectorized NumPy:
  1. sort triangles by the Morton code of their centroid (spatial coherence),
  2. chop the sorted order into LEAF_SIZE-triangle leaves, pad the leaf count
     to a power of two (empty leaves get far-away boxes + degenerate tris),
  3. build the complete binary tree bottom-up with pairwise AABB unions,
  4. compute every node's preorder position and skip link *analytically*
     from its (level, index-in-level) — no recursion, no Python-level loop
     over nodes.

An optional C++ builder (native/) can replace step 1-2 with binned SAH for
higher traversal quality; the array layout is identical.

The port's copy of rust_raytracer_tpu/scene/bvh_builder.py, held equal to it by
tests/test_torch_scene.py (both packages compile the same scenes to equal
tables).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

LEAF_SIZE = 4  # keep in sync with ops/intersect.py


class FlatBVH(NamedTuple):
    node_min: np.ndarray    # (M, 3) f32
    node_max: np.ndarray    # (M, 3) f32
    hit_link: np.ndarray    # (M,) i32
    miss_link: np.ndarray   # (M,) i32
    leaf_start: np.ndarray  # (M,) i32 (-1 internal)
    tri_order: np.ndarray   # (T_padded,) i64 indices into the input tris;
    #                          -1 marks degenerate padding slots


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis -> 30-bit Morton code. x in [0,1)^3."""
    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v

    q = np.clip((x * 1024.0).astype(np.int64), 0, 1023)
    return (
        expand(q[:, 0]) | (expand(q[:, 1]) << np.uint64(1)) | (expand(q[:, 2]) << np.uint64(2))
    )


def build(tri_min: np.ndarray, tri_max: np.ndarray,
          leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Build the threaded flat BVH from per-triangle AABBs (T, 3) each.

    Leaves own exactly `leaf_size` padded triangle slots.  The traversals
    use cluster-sized leaves (scene/compiler.CLUSTER): dense
    ray-tile x triangle-cluster tests beat deep per-lane descent on a
    vector machine.

    Prefers the native binned-SAH builder (native/bvh.cc) — much higher
    traversal quality than this NumPy Morton complete-tree fallback."""
    t = tri_min.shape[0]
    if t > 0:
        from .. import native

        built = (
            native.build_bvh(tri_min, tri_max, leaf_size)
            if native.available() else None
        )
        if built is not None:
            node_min, node_max, hit_link, miss_link, leaf_start, order = built
            return FlatBVH(
                node_min=node_min, node_max=node_max, hit_link=hit_link,
                miss_link=miss_link, leaf_start=leaf_start, tri_order=order,
            )
    if t == 0:
        return FlatBVH(
            node_min=np.zeros((0, 3), np.float32),
            node_max=np.zeros((0, 3), np.float32),
            hit_link=np.zeros((0,), np.int32),
            miss_link=np.zeros((0,), np.int32),
            leaf_start=np.zeros((0,), np.int32),
            tri_order=np.zeros((0,), np.int64),
        )

    centroid = (tri_min + tri_max) * 0.5
    lo = centroid.min(0)
    span = np.maximum(centroid.max(0) - lo, 1e-12)
    order = np.argsort(_morton3((centroid - lo) / span), kind="stable")

    n_leaves = -(-t // leaf_size)
    k = max(0, int(np.ceil(np.log2(max(n_leaves, 1)))))
    n_leaves_pad = 1 << k
    t_pad = n_leaves_pad * leaf_size

    tri_order = np.full((t_pad,), -1, np.int64)
    tri_order[:t] = order

    # leaf AABBs (empty/padded slots get a far-away point box)
    FAR = 1e30
    slot_min = np.full((t_pad, 3), FAR, np.float32)
    slot_max = np.full((t_pad, 3), FAR, np.float32)
    slot_min[:t] = tri_min[order]
    slot_max[:t] = tri_max[order]
    leaf_min = slot_min.reshape(n_leaves_pad, leaf_size, 3).min(1)
    leaf_max = slot_max.reshape(n_leaves_pad, leaf_size, 3).max(1)

    # bottom-up AABBs per level: level k = leaves ... level 0 = root
    mins = [leaf_min]
    maxs = [leaf_max]
    for _ in range(k):
        m = mins[-1]
        mins.append(np.minimum(m[0::2], m[1::2]))
        x = maxs[-1]
        maxs.append(np.maximum(x[0::2], x[1::2]))
    mins = mins[::-1]  # mins[level] for level = 0..k
    maxs = maxs[::-1]

    n_nodes = 2 * n_leaves_pad - 1
    node_min = np.zeros((n_nodes, 3), np.float32)
    node_max = np.zeros((n_nodes, 3), np.float32)
    hit_link = np.zeros((n_nodes,), np.int32)
    miss_link = np.zeros((n_nodes,), np.int32)
    leaf_start = np.full((n_nodes,), -1, np.int32)

    for level in range(k + 1):
        idx = np.arange(1 << level, dtype=np.int64)
        # preorder position: each step down costs 1; going right also skips
        # the left sibling's subtree of size 2^(k - j + 1) - 1 at depth j
        pre = np.zeros_like(idx)
        for j in range(1, level + 1):
            bit = (idx >> (level - j)) & 1
            pre += 1 + bit * ((1 << (k - j + 1)) - 1)
        subtree = (1 << (k - level + 1)) - 1
        node_min[pre] = mins[level]
        node_max[pre] = maxs[level]
        hit_link[pre] = pre + 1  # next node in preorder (first child)
        miss_link[pre] = pre + subtree
        if level == k:
            leaf_start[pre] = idx * leaf_size

    return FlatBVH(
        node_min=node_min,
        node_max=node_max,
        hit_link=hit_link,
        miss_link=miss_link,
        leaf_start=leaf_start,
        tri_order=tri_order,
    )
