"""Host-side 8-wide BVH (BVH8) collapse for the BVH8 traversal kernel.

The binary threaded BVH (scene/bvh_builder.py, native/bvh.cc — reference
semantics: object/bvh.rs + object/mesh/octree.rs) is the build structure;
the reference's TPU kernel (rust_raytracer_tpu/ops/pallas_bvh8.py) wants wide nodes so each traversal step
tests a full packet of rays against 8 child AABBs in a single
(8 sublanes x TILE lanes) VPU tile — 8x the node fanout of the threaded
walk at ~1/40th the per-step cost.

Collapse: starting from a binary node's two children, repeatedly replace
the internal child with the largest surface area by its own two children
until there are 8 slots or only leaves remain (the standard BVH2->BVH8
greedy collapse).  Children are ordered by Morton code of their centroid
so the static pop order follows a space-filling curve.

Leaves ARE the builder's clusters: binned-SAH leaf boxes stay tight,
which beats fill — re-packing small leaves into full clusters was
measured 2x MORE union leaf visits (fat run-union boxes), so no packing
pass exists here.

Kernel-facing layout (the port's kernel reads it repacked, scene/pack.py):
  aabb8:  (n8, 8, 128) f32 — [node, child_slot, field]; fields 0-5 are
          lo_x, lo_y, lo_z, hi_x, hi_y, hi_z; empty slots get inverted
          (+BIG/-BIG) boxes that never hit.  Lane 6 holds the slot's child
          id as an exact small float (0 empty, >0 internal BVH8 node id,
          <0 leaf: cluster id = -(c+1); node 0 is the root and never a
          child, so 0 can mean "empty").  Lanes 7-127 are tile padding.
  child8: (n8, 8) int32 — the lane-6 data as integers (the kernel reads
          child ids from SMEM; floats in lane 6 remain for debugging).

The port's copy of rust_raytracer_tpu/scene/bvh8.py, held equal to it by
tests/test_torch_scene.py (both packages compile the same scenes to equal
tables).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import bvh_builder

BIG = 3.0e38


class BVH8(NamedTuple):
    aabb8: np.ndarray   # (n8, 8, 128) f32
    child8: np.ndarray  # (n8, 8) int32


def _morton3_single(p: np.ndarray) -> int:
    q = np.clip((p * 1023.0).astype(np.int64), 0, 1023)

    def expand(v):
        v = int(v)
        v = (v | (v << 32)) & 0x1F00000000FFFF
        v = (v | (v << 16)) & 0x1F0000FF0000FF
        v = (v | (v << 8)) & 0x100F00F00F00F00F
        v = (v | (v << 4)) & 0x10C30C30C30C30C3
        v = (v | (v << 2)) & 0x1249249249249249
        return v

    return expand(q[0]) | (expand(q[1]) << 1) | (expand(q[2]) << 2)


def collapse(bvh: bvh_builder.FlatBVH, cluster: int) -> BVH8:
    """Collapse the threaded binary BVH into BVH8 tables.

    `cluster` is the triangle count per leaf (== the builder's leaf_size);
    binary leaf_start / cluster is the cluster id the kernel indexes
    tri geometry blocks with.
    """
    node_min = bvh.node_min
    node_max = bvh.node_max
    leaf_start = bvh.leaf_start
    miss = bvh.miss_link
    n_bin = node_min.shape[0]

    if n_bin == 0:
        return BVH8(
            aabb8=np.zeros((0, 8, 128), np.float32),
            child8=np.zeros((0, 8), np.int32),
        )

    def kids(n: int):
        """Children of binary internal node n (preorder: first child is
        n + 1, second child follows the first child's subtree)."""
        c1 = n + 1
        c2 = int(miss[c1])
        return c1, c2

    area = (node_max - node_min)
    area = 2.0 * (
        area[:, 0] * area[:, 1] + area[:, 1] * area[:, 2] + area[:, 0] * area[:, 2]
    )

    # scene extent for Morton child ordering
    lo = node_min[0]
    span = np.maximum(node_max[0] - lo, 1e-12)

    # Worklist of (bvh8_id, binary_node). BVH8 ids assigned on creation.
    if leaf_start[0] >= 0:
        # degenerate: root is a single leaf
        aabb = np.full((8, 128), 0.0, np.float32)
        aabb[:, 0:3] = BIG
        aabb[:, 3:6] = -BIG
        aabb[0, 0:3] = node_min[0]
        aabb[0, 3:6] = node_max[0]
        ch = np.zeros((8,), np.int32)
        ch[0] = -(int(leaf_start[0]) // cluster + 1)
        aabb[:, 6] = ch.astype(np.float32)
        return BVH8(aabb8=aabb[None], child8=ch[None])

    aabb_rows = []  # per BVH8 node: (8, 6) f32
    child_rows = []  # per BVH8 node: (8,) i32
    next_id = 1
    work = [(0, 0)]
    while work:
        my_id, n = work.pop()
        # grow the child set greedily by splitting the largest internal
        slots = list(kids(n))
        while len(slots) < 8:
            best = -1
            best_a = -1.0
            for i, s in enumerate(slots):
                if leaf_start[s] < 0 and area[s] > best_a:
                    best_a = area[s]
                    best = i
            if best < 0:
                break
            s = slots.pop(best)
            slots.extend(kids(s))
        # order children along the Morton curve of their centroids
        slots.sort(
            key=lambda s: _morton3_single(
                ((node_min[s] + node_max[s]) * 0.5 - lo) / span
            )
        )
        ab = np.zeros((8, 6), np.float32)
        ab[:, 0:3] = BIG
        ab[:, 3:6] = -BIG
        ch = np.zeros((8,), np.int32)
        for k, s in enumerate(slots):
            ab[k, 0:3] = node_min[s]
            ab[k, 3:6] = node_max[s]
            if leaf_start[s] < 0:
                ch[k] = next_id
                work.append((next_id, s))
                next_id += 1
            else:
                ch[k] = -(int(leaf_start[s]) // cluster + 1)

        while len(aabb_rows) <= my_id:
            aabb_rows.append(None)
            child_rows.append(None)
        aabb_rows[my_id] = ab
        child_rows[my_id] = ch

    n8 = next_id
    aabb8 = np.zeros((n8, 8, 128), np.float32)
    aabb8[:, :, 0:3] = BIG
    aabb8[:, :, 3:6] = -BIG
    aabb8[:, :, 0:6] = np.stack(aabb_rows[:n8])
    child8 = np.stack(child_rows[:n8]).astype(np.int32)
    aabb8[:, :, 6] = child8.astype(np.float32)

    return BVH8(aabb8=aabb8, child8=child8)
