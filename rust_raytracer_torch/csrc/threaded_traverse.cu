// Closest-hit ray traversal of the threaded binary BVH (K3) on Hopper.
//
// Replaces the Pallas TPU kernel rust_raytracer_tpu/ops/pallas_intersect.py:
// _kernel (its wrappers _traverse / intersect_triangles_pallas).  It computes
// the same thing: for each ray, the closest triangle hit by a stackless walk
// of the threaded BVH from node 0 until the cursor passes the last node — on
// a box hit the cursor takes the node's hit link (a leaf first tests its
// 128-triangle cluster with Möller–Trumbore), on a miss its miss link — and
// returns (t, slot) with slot = cluster * 128 + lane, or the caller's t_max
// and -1 where nothing was hit.  As in the reference kernel, the slab's near
// distance is not clamped at T_MIN and its far distance is clamped at the
// ray's best t; the best starts at min(t_max, 3.4e38).
//
// What bounds it on this card: not FLOPs and not bandwidth, but a chain of
// dependent loads.  Each step reads one 32-byte node whose address is the
// previous step's link, and a binary node prunes half as much as a BVH8
// node's 8 children (ops/bvh8.py), so a ray takes several times the BVH8
// walk's steps; rays of one warp take different branches (divergence) and
// idle while their neighbours walk.
//
// This first design is simple and exact, the per-ray form of the reference's
// walk: one thread per ray, 128 threads per block, each thread with its own
// cursor.  The TPU kernel's shared packet cursor and per-leaf DMA into VMEM
// serve VMEM and have no counterpart here.  The node table is compact (one
// 32-byte sector a node, read through the read-only cache); rays arrive in
// compaction-sort order (render/integrator.py:_compaction_key), so the
// threads of a warp mostly read the same nodes and clusters and those loads
// coalesce in L1/L2.  A lane whose best t starts at or below T_MIN (a dead
// lane: t_max = 0) can accept no triangle and skips the walk, which changes
// no result.  Left for later work: node prefetch, a wider node, persistent
// threads.
//
// The walk visits nodes in the order of the plain version
// (ops/threaded.py:traverse_plain, the reference's oracle), which clamps
// near at T_MIN: the extra boxes this kernel enters lie behind T_MIN and
// hold no acceptable hit, so (t, slot) equal the plain version's, ties
// included.

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse_common.cuh"

#define THREADS 128

// nodes:  (m, 8) f32 as 2 float4 a node: lo_xyz, hi_x | hi_yz, then two
//         int32 bit patterns: miss link, and hit link (internal) or
//         -(cluster + 1) (leaf)
// tri:    (n_clusters * 128, 12) f32  v0, e1, e2, hit_back, 0, 0
// org, dirn: (n, 3) f32;  t_max: (n,) f32
// t_out: (n,) f32;  slot_out: (n,) i32
__global__ void __launch_bounds__(THREADS)
threaded_traverse_kernel(const float4* __restrict__ nodes,
                         const float* __restrict__ tri,
                         const float* __restrict__ org,
                         const float* __restrict__ dirn,
                         const float* __restrict__ t_max,
                         float* __restrict__ t_out,
                         int* __restrict__ slot_out,
                         int n, int n_nodes) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    const float ox = org[3 * i], oy = org[3 * i + 1], oz = org[3 * i + 2];
    const float dx = dirn[3 * i], dy = dirn[3 * i + 1], dz = dirn[3 * i + 2];
    const float inv_x = 1.0f / dx, inv_y = 1.0f / dy, inv_z = 1.0f / dz;
    const float tmax = t_max[i];

    // +inf clamps to BIG: an all-miss cluster must not beat the initial best
    float best_t = rrt::nan_min(tmax, rrt::kBig);
    int best_i = -1;

    int node = best_t > rrt::kTMin ? 0 : n_nodes;
    while (node < n_nodes) {
        const float4 a = __ldg(nodes + 2 * node);      // lo_x lo_y lo_z hi_x
        const float4 b = __ldg(nodes + 2 * node + 1);  // hi_y hi_z miss hit|leaf
        const float tx0 = (a.x - ox) * inv_x;
        const float tx1 = (a.w - ox) * inv_x;
        const float ty0 = (a.y - oy) * inv_y;
        const float ty1 = (b.x - oy) * inv_y;
        const float tz0 = (a.z - oz) * inv_z;
        const float tz1 = (b.y - oz) * inv_z;
        const float near = rrt::nan_max(
            rrt::nan_max(rrt::nan_min(tx0, tx1), rrt::nan_min(ty0, ty1)),
            rrt::nan_min(tz0, tz1));
        const float far = rrt::nan_min(
            rrt::nan_min(rrt::nan_max(tx0, tx1), rrt::nan_max(ty0, ty1)),
            rrt::nan_min(rrt::nan_max(tz0, tz1), best_t));
        const int miss = __float_as_int(b.z);
        const int link = __float_as_int(b.w);
        if (near <= far) {
            if (link < 0) {
                rrt::mt_cluster(tri, -link - 1, ox, oy, oz, dx, dy, dz, best_t, best_i);
                node = miss;  // a leaf's hit link is its miss link
            } else {
                node = link;
            }
        } else {
            node = miss;
        }
    }

    // parity with the reference wrapper: the caller's t_max on a miss
    t_out[i] = best_i < 0 ? tmax : best_t;
    slot_out[i] = best_i;
}

extern "C" int rrt_threaded_traverse(const float* nodes, const float* tri,
                                     const float* org, const float* dirn,
                                     const float* t_max, float* t_out,
                                     int* slot_out, int n, int n_nodes,
                                     cudaStream_t stream) {
    if (n <= 0) return 0;
    const int blocks = (n + THREADS - 1) / THREADS;
    threaded_traverse_kernel<<<blocks, THREADS, 0, stream>>>(
        reinterpret_cast<const float4*>(nodes), tri, org, dirn, t_max, t_out,
        slot_out, n, n_nodes);
    return (int)cudaGetLastError();
}
