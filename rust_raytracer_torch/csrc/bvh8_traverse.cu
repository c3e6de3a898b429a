// Closest-hit ray traversal of the 8-wide BVH (BVH8) on Hopper.
//
// Replaces the Pallas TPU kernel rust_raytracer_tpu/ops/pallas_bvh8.py:_kernel
// (its wrapper _traverse / intersect_triangles_bvh8).  It computes the same
// thing: for each ray, the closest triangle hit by a stack walk of the BVH8 —
// slab test of a node's 8 children, Möller–Trumbore over 128-triangle leaf
// clusters — and returns (t, slot) with slot = cluster * 128 + lane, or the
// caller's t_max and -1 where nothing was hit.
//
// Design: one thread per ray, 128 threads per block, the stack of STACK
// ints in local memory (L1-cached); the walk loop runs while any lane of
// the warp has a non-empty stack.  On each iteration every walking lane
// pops one entry: an internal node has its 8 children slab-tested and the
// hits pushed 7 -> 0 (slot 0, first on the Morton curve, pops first); a
// leaf is marked pending, and the warp then tests the pending leaves one
// after another, all 32 lanes on one cluster's 128 slots
// (traverse_common.cuh:warp_leaf_test).  Each ray pops its entries in the
// per-thread walk's order with its best t, so (t, slot) equal that walk's
// (chip_smoke.py:bvh8_walk) slot for slot.  Rays arrive in compaction-sort
// order (render/integrator.py:_compaction_key: direction octant, then
// origin Morton code), so the lanes of a warp walk mostly the same nodes.
// The TPU kernel's 128-ray packet union, its SMEM stack and VMEM budget
// have no counterpart here.
//
// What bounds it on this card: not FLOPs, but the warp's serial steps and
// the bytes of the leaves it reads.  A per-thread leaf loop ran 128
// Möller–Trumbore iterations for every warp iteration in which any lane
// held a leaf, with 7-15% of the lanes busy: on 2^18 bounce rays of
// cornell_dragon, 167,397 leaf visits in 71,039 warp leaf passes (8.7 a
// warp) and 3.3 ms (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py).  The
// cooperative test costs a leaf visit 4 Möller–Trumbore steps and 18
// shuffles a lane (the equivalent of 0.64 passes a warp there) and takes
// those rays under 1 ms (PERF.md, section 6).  What is left: every leaf
// visit reads its cluster's 6 KB of rows (1.0 GB over those rays), and
// each pop of an internal node reads a 192-byte box row and the child ids
// and runs 8 slab tests in series.  Left for later work: near-first child
// order (it changes which slot wins an equal-t tie), a smaller triangle
// row, wide-node prefetch, a shared-memory stack, persistent threads.
//
// Arithmetic is the reference kernel's, operation for operation
// (traverse_common.cuh: NaN-propagating min/max, the shared Möller–Trumbore
// slot test), so every t equals the plain PyTorch version's
// (ops/threaded.py:traverse_plain) for the same triangle.

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse_common.cuh"

#define STACK 160          // must match ops/bvh8.py:STACK
#define THREADS 128

using rrt::nan_max;
using rrt::nan_min;

// box8:   (n8, 8, 6) f32  child AABBs lo_xyz, hi_xyz (empty slots inverted)
// child8: (n8, 8) i32     0 empty | >0 BVH8 node id | <0 ~cluster id
// tri:    (n_clusters * 128, 12) f32  v0, e1, e2, hit_back, 0, 0
// org, dirn: (n, 3) f32;  t_max: (n,) f32
// t_out: (n,) f32;  slot_out: (n,) i32
__global__ void __launch_bounds__(THREADS)
bvh8_traverse_kernel(const float* __restrict__ box8,
                     const int* __restrict__ child8,
                     const float* __restrict__ tri,
                     const float* __restrict__ org,
                     const float* __restrict__ dirn,
                     const float* __restrict__ t_max,
                     float* __restrict__ t_out,
                     int* __restrict__ slot_out,
                     int n) {
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
    float best_t = nan_min(tmax, rrt::kBig);
    int best_i = -1;

    int stack[STACK];
    int sp = valid ? 1 : 0;
    stack[0] = 0;

    while (__any_sync(rrt::kFullMask, sp > 0)) {
        bool pending = false;
        int cluster = 0;
        if (sp > 0) {
            const int v = stack[--sp];
            if (v < 0) {
                pending = true;  // tested below, before this lane's next pop
                cluster = -v - 1;
            } else {
                // internal node: slab-test the 8 children, push hits 7 -> 0 so
                // slot 0 (first on the Morton curve) pops first
                const float* box = box8 + (size_t)v * 48;
                const int* kids = child8 + (size_t)v * 8;
                for (int c = 7; c >= 0; --c) {
                    const int child = kids[c];
                    if (child == 0) continue;  // empty slot (its box is inverted)
                    const float* b = box + 6 * c;
                    const float tx0 = (b[0] - ox) * inv_x;
                    const float tx1 = (b[3] - ox) * inv_x;
                    const float ty0 = (b[1] - oy) * inv_y;
                    const float ty1 = (b[4] - oy) * inv_y;
                    const float tz0 = (b[2] - oz) * inv_z;
                    const float tz1 = (b[5] - oz) * inv_z;
                    const float near = nan_max(
                        nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                        nan_max(nan_min(tz0, tz1), rrt::kTMin));
                    const float far = nan_min(
                        nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                        nan_min(nan_max(tz0, tz1), best_t));
                    if (near <= far) stack[sp++] = child;
                }
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

extern "C" int rrt_bvh8_traverse(const float* box8, const int* child8,
                                 const float* tri, const float* org,
                                 const float* dirn, const float* t_max,
                                 float* t_out, int* slot_out, int n,
                                 cudaStream_t stream) {
    if (n <= 0) return 0;
    const int blocks = (n + THREADS - 1) / THREADS;
    bvh8_traverse_kernel<<<blocks, THREADS, 0, stream>>>(
        box8, child8, tri, org, dirn, t_max, t_out, slot_out, n);
    return (int)cudaGetLastError();
}

// The kernel's registers a thread, local bytes a thread (stack frame and
// spills) and static shared bytes, as the loaded module reports them.
extern "C" int rrt_bvh8_traverse_attrs(int* out) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, bvh8_traverse_kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    return 0;
}
