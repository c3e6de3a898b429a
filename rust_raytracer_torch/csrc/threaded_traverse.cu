// Closest-hit ray traversal of the threaded binary BVH (K3) on Hopper.
//
// Replaces the Pallas TPU kernel rust_raytracer_tpu/ops/pallas_intersect.py:
// _kernel (its wrappers _traverse / intersect_triangles_pallas).  It computes
// the same thing: for each ray, the closest triangle hit by a stackless walk
// of the threaded BVH from node 0 until the cursor passes the last node — on
// a box hit the cursor takes the node's hit link (a leaf first tests its
// 128-triangle cluster with Möller–Trumbore), on a miss its miss link — and
// returns (t, slot) with slot = cluster * 128 + lane, or the caller's t_max
// and -1 where nothing was hit.  The slab's near distance is clamped at
// T_MIN and its far distance at the ray's best t, which starts at
// min(t_max, 3.4e38).  The reference kernel leaves near unclamped; a box
// whose far distance is below T_MIN holds only hits that Möller–Trumbore
// rejects, so the clamp changes no result and skips those boxes.
//
// Design: one thread per ray, each with its own cursor, 128 threads per
// block; the walk loop runs while any lane of the warp is still walking.
// On each iteration every walking lane takes one node step (one 32-byte
// node read as two float4 through the read-only cache); a lane whose step
// lands on a leaf it must test marks it pending, and the warp then tests
// the pending leaves one after another, all 32 lanes on one cluster's 128
// slots (traverse_common.cuh:warp_leaf_test).  A lane tests its leaf
// before its next slab test, so every ray visits the plain version's nodes
// (ops/threaded.py:traverse_plain) in its order with its best t, and
// (t, slot) equal the plain version's, ties included.
//
// What bounds it on this card: not FLOPs, but the warp's serial steps and
// the bytes of the leaves it reads.  A per-thread leaf loop ran 128
// Möller–Trumbore iterations for every warp iteration in which any lane
// held a leaf, with 5-6% of the lanes busy: on 2^18 sorted bounce rays of
// cornell_dragon, 165,637 leaf visits in 95,933 warp leaf passes (11.7 a
// warp) and 12.3 ms (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py).  The
// cooperative test costs a leaf visit 4 Möller–Trumbore steps and 18
// shuffles a lane (the equivalent of 0.63 passes a warp there) and takes
// those rays under 1 ms (PERF.md, section 6).  What is left: every leaf
// visit reads its cluster's 6 KB of rows (1.0 GB over those rays) and
// every ray's 34 node steps a warp are a chain of dependent loads.  Left
// for later work: a smaller triangle row, node prefetch, a wider node,
// sharing one cluster's rows among pending lanes that hold the same
// cluster, persistent threads.

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
    // a lane past n still takes part in its warp's leaf tests (the
    // shuffles need all 32 lanes) but walks nothing
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool valid = i < n;
    const int r = valid ? i : 0;

    const float ox = org[3 * r], oy = org[3 * r + 1], oz = org[3 * r + 2];
    const float dx = dirn[3 * r], dy = dirn[3 * r + 1], dz = dirn[3 * r + 2];
    const float inv_x = 1.0f / dx, inv_y = 1.0f / dy, inv_z = 1.0f / dz;
    const float tmax = t_max[r];

    // +inf clamps to BIG: an all-miss cluster must not beat the initial best
    float best_t = rrt::nan_min(tmax, rrt::kBig);
    int best_i = -1;

    int node = valid ? 0 : n_nodes;
    while (__any_sync(rrt::kFullMask, node < n_nodes)) {
        bool pending = false;
        int cluster = 0;
        if (node < n_nodes) {
            const float4 a = __ldg(nodes + 2 * node);      // lo_x lo_y lo_z hi_x
            const float4 b = __ldg(nodes + 2 * node + 1);  // hi_y hi_z miss hit|leaf
            const float tx0 = (a.x - ox) * inv_x;
            const float tx1 = (a.w - ox) * inv_x;
            const float ty0 = (a.y - oy) * inv_y;
            const float ty1 = (b.x - oy) * inv_y;
            const float tz0 = (a.z - oz) * inv_z;
            const float tz1 = (b.y - oz) * inv_z;
            const float near = rrt::nan_max(
                rrt::nan_max(rrt::nan_max(rrt::nan_min(tx0, tx1), rrt::nan_min(ty0, ty1)),
                             rrt::nan_min(tz0, tz1)),
                rrt::kTMin);
            const float far = rrt::nan_min(
                rrt::nan_min(rrt::nan_max(tx0, tx1), rrt::nan_max(ty0, ty1)),
                rrt::nan_min(rrt::nan_max(tz0, tz1), best_t));
            const int miss = __float_as_int(b.z);
            const int link = __float_as_int(b.w);
            if (near <= far && link < 0) {
                pending = true;  // tested below, before this lane's next slab test
                cluster = -link - 1;
                node = miss;     // a leaf's hit link is its miss link
            } else {
                node = near <= far ? link : miss;
            }
        }
        rrt::warp_leaf_test(tri, pending, cluster, ox, oy, oz, dx, dy, dz, best_t, best_i);
    }

    if (valid) {
        // parity with the reference wrapper: the caller's t_max on a miss
        t_out[i] = best_i < 0 ? tmax : best_t;
        slot_out[i] = best_i;
    }
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

// The kernel's registers a thread, local bytes a thread (stack frame and
// spills) and static shared bytes, as the loaded module reports them.
extern "C" int rrt_threaded_traverse_attrs(int* out) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, threaded_traverse_kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    return 0;
}
