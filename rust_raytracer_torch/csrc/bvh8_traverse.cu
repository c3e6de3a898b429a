// Closest-hit ray traversal of the 8-wide BVH (BVH8) on Hopper.
//
// Replaces the Pallas TPU kernel rust_raytracer_tpu/ops/pallas_bvh8.py:_kernel
// (its wrapper _traverse / intersect_triangles_bvh8).  It computes the same
// thing: for each ray, the closest triangle hit by a stack walk of the BVH8 —
// slab test of a node's 8 children, Möller–Trumbore over 128-triangle leaf
// clusters — and returns (t, slot) with slot = cluster * 128 + lane, or the
// caller's t_max and -1 where nothing was hit.
//
// What bounds it on this card: not FLOPs.  Each traversal step is a
// dependent load (a 192-byte node, then 48-byte triangle rows) whose
// address comes from the previous step, so the walk is bound by memory
// latency; and rays of one warp take different paths (divergence), so lanes
// idle while their neighbours walk.
//
// This first design is simple and exact: one thread per ray, 128 threads
// per block, the stack of STACK ints in local memory (L1-cached).  Rays
// arrive in compaction-sort order (render/integrator.py:_compaction_key:
// direction octant, then origin Morton code), so the threads of a warp
// walk mostly the same nodes and their loads coalesce in L1/L2.  The TPU
// kernel's 128-ray packet union, its SMEM stack and VMEM budget have no
// counterpart here.  Left for later work: wide-node prefetch, a shared-memory
// stack, persistent threads with a work queue, near-first child order.
//
// Arithmetic is the reference kernel's, operation for operation, and the
// library is built with -fmad=false and without --use_fast_math: no FMA
// contraction and IEEE division (div.rn), so every t equals the plain
// PyTorch version's (ops/bvh8.py:traverse_plain) for the same triangle.
// min/max in the slab test propagate NaN as jnp.minimum/maximum do: a box
// whose slab product is NaN (zero direction component with the origin on
// the slab plane) is rejected, as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#define STACK 160          // must match ops/bvh8.py:STACK
#define CLUSTER 128
#define DET_EPS 1e-12f
#define T_MIN_STATIC 1e-3f
#define BIG 3.4e38f
#define THREADS 128

__device__ __forceinline__ float nan_min(float a, float b) {
    return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}

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
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    const float ox = org[3 * i], oy = org[3 * i + 1], oz = org[3 * i + 2];
    const float dx = dirn[3 * i], dy = dirn[3 * i + 1], dz = dirn[3 * i + 2];
    const float inv_x = 1.0f / dx, inv_y = 1.0f / dy, inv_z = 1.0f / dz;
    const float tmax = t_max[i];

    // +inf clamps to BIG: an all-miss cluster must not beat the initial best
    float best_t = nan_min(tmax, BIG);
    int best_i = -1;

    int stack[STACK];
    int sp = 1;
    stack[0] = 0;

    while (sp > 0) {
        const int v = stack[--sp];
        if (v < 0) {
            // leaf: Möller–Trumbore over the cluster's 128 triangle slots;
            // a sequential strict `<` keeps the lowest lane at equal t
            const int cluster = -v - 1;
            const float4* rows = reinterpret_cast<const float4*>(tri) +
                                 (size_t)cluster * CLUSTER * 3;
            for (int k = 0; k < CLUSTER; ++k) {
                const float4 r0 = rows[3 * k];
                const float4 r1 = rows[3 * k + 1];
                const float4 r2 = rows[3 * k + 2];
                const float v0x = r0.x, v0y = r0.y, v0z = r0.z;
                const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
                const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
                const float back = r2.y;

                const float px = dy * e2z - dz * e2y;
                const float py = dz * e2x - dx * e2z;
                const float pz = dx * e2y - dy * e2x;
                const float det = e1x * px + e1y * py + e1z * pz;
                const float dd = back > 0.5f ? fabsf(det) : det;
                const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
                const float bx = ox - v0x;
                const float by = oy - v0y;
                const float bz = oz - v0z;
                const float u = (bx * px + by * py + bz * pz) * inv_det;
                const float qx = by * e1z - bz * e1y;
                const float qy = bz * e1x - bx * e1z;
                const float qz = bx * e1y - by * e1x;
                const float w = (dx * qx + dy * qy + dz * qz) * inv_det;
                const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
                const bool ok = (dd > DET_EPS) && (u >= 0.0f) && (u <= 1.0f) &&
                                (w >= 0.0f) && (u + w <= 1.0f) &&
                                (t > T_MIN_STATIC) && (t < best_t);
                if (ok) {
                    best_t = t;
                    best_i = cluster * CLUSTER + k;
                }
            }
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
                    nan_max(nan_min(tz0, tz1), T_MIN_STATIC));
                const float far = nan_min(
                    nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                    nan_min(nan_max(tz0, tz1), best_t));
                if (near <= far) stack[sp++] = child;
            }
        }
    }

    // parity with the reference wrapper: the caller's t_max on a miss
    t_out[i] = best_i < 0 ? tmax : best_t;
    slot_out[i] = best_i;
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
