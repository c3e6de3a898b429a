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
// after another, all 32 lanes on the groups of 32 slots of one cluster
// that its ray enters (warp_leaf_test below).  Each ray pops its entries in the
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
// cooperative test took those rays under 1 ms (PERF.md, section 6), and
// then every leaf visit read its cluster's 6 KB of rows (1.0 GB over those
// rays).  So a leaf visit tests only the groups of 32 slots whose box the
// ray enters (warp_leaf_test below): the kernel reads a copy of the rows
// with each cluster's slots ordered by the Morton code of their centroids
// (scene/pack.py:bvh8_leaf_tables), so a group's 32 rows are contiguous
// and its box is tight; a bounce ray's leaf visit tests ~41% of the 4
// groups on cornell_dragon (bytes a visit 6,144 -> ~2,600).  Each pop of an internal node reads a
// 192-byte box row and the child ids and runs 8 slab tests in series.
// Left for later work: near-first child order (it changes which slot wins
// an equal-t tie), a smaller triangle row, wide-node prefetch, a
// shared-memory stack, persistent threads.
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

using rrt::kFullMask;
using rrt::nan_max;
using rrt::nan_min;

constexpr int kGroup = 32;                        // rows a group, scene/pack.py:GROUP
constexpr int kGroups = rrt::kCluster / kGroup;   // groups a cluster
constexpr int kSlabRays = rrt::kWarp / kGroups;   // pending rays a slab pass

// The slab test of the walk: the box (lo xyz, hi xyz) is entered within
// [T_MIN, best] (NaN-propagating min/max: a NaN slab rejects it).
__device__ __forceinline__ bool slab_enter(const float* __restrict__ b, float ox, float oy,
                                           float oz, float inv_x, float inv_y, float inv_z,
                                           float best) {
    const float tx0 = (b[0] - ox) * inv_x;
    const float tx1 = (b[3] - ox) * inv_x;
    const float ty0 = (b[1] - oy) * inv_y;
    const float ty1 = (b[4] - oy) * inv_y;
    const float tz0 = (b[2] - oz) * inv_z;
    const float tz1 = (b[5] - oz) * inv_z;
    const float near = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                               nan_max(nan_min(tz0, tz1), rrt::kTMin));
    const float far = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                              nan_min(nan_max(tz0, tz1), best));
    return near <= far;
}

// The position of the set bit of m that has q set bits below it, or -1.
__device__ __forceinline__ int nth_bit(unsigned m, int q) {
    for (int k = 0; k < q; ++k) m &= m - 1;
    return m ? __ffs(m) - 1 : -1;
}

// The leaf test, done by the whole warp.  Every lane calls it in the same
// iteration of its walk loop; a lane whose step landed on a leaf passes
// pending = true and that cluster's id.
//
// 1. Slab pass, up to kSlabRays pending lanes at once: lane 4q + g tests
//    the box of group g of the q-th pending lane's cluster with the node
//    test's slab (near clamped at T_MIN, far at that lane's best t); an
//    inverted box, a group of padding alone, is not entered.  One ballot
//    holds each of those lanes' 4-bit mask of entered groups.
// 2. For each of them in turn, lowest lane first: its ray, best t and
//    cluster go to all 32 lanes; for each entered group j, lane k tests
//    leaf row 32 j + k (the rows of every entered group in flight at once),
//    whose column 10 holds its slot, keeping its least (t, slot); a 5-step
//    butterfly takes the warp's lexicographic least (t, slot); the owning
//    lane accepts it only if it is strictly below its best t.
//
// That equals the full scan of the 128 slots (and so the sequential scan
// with a strict `<`): a group's box, widened outward, holds its triangles,
// so a group not entered has no slot hit with T_MIN < t < best; each
// tested slot's t is mt_row's, bit for bit; and the least t, lowest slot
// at that t, does not depend on the order the slots are tested in.
// `n_leaf` and `n_group` (warp-uniform) add the leaf visits and the groups
// tested.
__device__ __forceinline__ void warp_leaf_test(const float* __restrict__ leaf,
                                               const float* __restrict__ gbox,
                                               bool pending, int cluster,
                                               float ox, float oy, float oz,
                                               float dx, float dy, float dz,
                                               float inv_x, float inv_y, float inv_z,
                                               float& best_t, int& best_i,
                                               unsigned& n_leaf, unsigned& n_group) {
    const int lane = threadIdx.x & (rrt::kWarp - 1);
    unsigned todo = __ballot_sync(kFullMask, pending);
    n_leaf += __popc(todo);
    while (todo) {
        const int q = lane / kGroups, g = lane % kGroups;
        const int src_q = nth_bit(todo, q);
        const int from = src_q < 0 ? 0 : src_q;
        const int cq = __shfl_sync(kFullMask, cluster, from);
        const float qox = __shfl_sync(kFullMask, ox, from);
        const float qoy = __shfl_sync(kFullMask, oy, from);
        const float qoz = __shfl_sync(kFullMask, oz, from);
        const float qix = __shfl_sync(kFullMask, inv_x, from);
        const float qiy = __shfl_sync(kFullMask, inv_y, from);
        const float qiz = __shfl_sync(kFullMask, inv_z, from);
        const float qbest = __shfl_sync(kFullMask, best_t, from);
        const float* b = gbox + ((size_t)cq * kGroups + g) * 6;
        const bool enter = src_q >= 0 && b[0] <= b[3] &&
                           slab_enter(b, qox, qoy, qoz, qix, qiy, qiz, qbest);
        const unsigned entered = __ballot_sync(kFullMask, enter);

        for (int k = 0; k < kSlabRays && todo; ++k) {
            const int src = __ffs(todo) - 1;
            todo &= todo - 1;
            unsigned groups = (entered >> (kGroups * k)) & ((1u << kGroups) - 1);
            if (!groups) continue;
            const int n_groups = __popc(groups);
            n_group += n_groups;
            const int c = __shfl_sync(kFullMask, cluster, src);
            const float sox = __shfl_sync(kFullMask, ox, src);
            const float soy = __shfl_sync(kFullMask, oy, src);
            const float soz = __shfl_sync(kFullMask, oz, src);
            const float sdx = __shfl_sync(kFullMask, dx, src);
            const float sdy = __shfl_sync(kFullMask, dy, src);
            const float sdz = __shfl_sync(kFullMask, dz, src);
            const float sbest = __shfl_sync(kFullMask, best_t, src);
            const float4* rows = reinterpret_cast<const float4*>(leaf) +
                                 ((size_t)c * rrt::kCluster + lane) * 3;

            // each pass's group, then every pass's row in flight at once
            int group_of[kGroups];
#pragma unroll
            for (int p = 0; p < kGroups; ++p) {
                group_of[p] = groups ? __ffs(groups) - 1 : 0;
                groups &= groups - 1;
            }
            float4 r0[kGroups], r1[kGroups], r2[kGroups];
#pragma unroll
            for (int p = 0; p < kGroups; ++p) {
                if (p < n_groups) {
                    const float4* row = rows + 3 * kGroup * group_of[p];
                    r0[p] = __ldg(row);
                    r1[p] = __ldg(row + 1);
                    r2[p] = __ldg(row + 2);
                }
            }
            float t = __int_as_float(0x7f800000);
            int slot = rrt::kCluster;
#pragma unroll
            for (int p = 0; p < kGroups; ++p) {
                if (p < n_groups) {
                    const float tk = rrt::mt_row(r0[p], r1[p], r2[p], sox, soy, soz, sdx, sdy,
                                                 sdz, sbest);
                    const int sk = __float_as_int(r2[p].z);  // the row's slot
                    if (tk < t || (tk == t && sk < slot)) {
                        t = tk;
                        slot = sk;
                    }
                }
            }
#pragma unroll
            for (int m = rrt::kWarp / 2; m > 0; m >>= 1) {
                const float ot = __shfl_xor_sync(kFullMask, t, m);
                const int os = __shfl_xor_sync(kFullMask, slot, m);
                if (ot < t || (ot == t && os < slot)) {
                    t = ot;
                    slot = os;
                }
            }
            if (lane == src && t < best_t) {
                best_t = t;
                best_i = c * rrt::kCluster + slot;
            }
        }
    }
}

// box8:   (n8, 8, 6) f32  child AABBs lo_xyz, hi_xyz (empty slots inverted)
// child8: (n8, 8) i32     0 empty | >0 BVH8 node id | <0 ~cluster id
// leaf:   (n_clusters * 128, 12) f32  v0, e1, e2, hit_back, slot (int32
//         bits), 0: each cluster's rows in Morton order, padding last
// gbox:   (n_clusters, 4, 6) f32  the box of each group of 32 leaf rows (a
//         padding group's inverted)
// org, dirn: (n, 3) f32;  t_max: (n,) f32
// t_out: (n,) f32;  slot_out: (n,) i32
// counts: null, or (2,) i64 += leaf visits, groups tested (an atomic a
//         warp each)
__global__ void __launch_bounds__(THREADS)
bvh8_traverse_kernel(const float* __restrict__ box8,
                     const int* __restrict__ child8,
                     const float* __restrict__ leaf,
                     const float* __restrict__ gbox,
                     const float* __restrict__ org,
                     const float* __restrict__ dirn,
                     const float* __restrict__ t_max,
                     float* __restrict__ t_out,
                     int* __restrict__ slot_out,
                     long long* __restrict__ counts,
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
    unsigned n_leaf = 0, n_group = 0;

    int stack[STACK];
    int sp = valid ? 1 : 0;
    stack[0] = 0;

    while (__any_sync(kFullMask, sp > 0)) {
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
                    if (slab_enter(box + 6 * c, ox, oy, oz, inv_x, inv_y, inv_z, best_t))
                        stack[sp++] = child;
                }
            }
        }
        warp_leaf_test(leaf, gbox, pending, cluster, ox, oy, oz, dx, dy, dz, inv_x,
                       inv_y, inv_z, best_t, best_i, n_leaf, n_group);
    }

    if (valid) {
        // parity with the reference wrapper: the caller's t_max on a miss
        t_out[i] = best_i < 0 ? tmax : best_t;
        slot_out[i] = best_i;
    }
    if (counts != nullptr && (threadIdx.x & (rrt::kWarp - 1)) == 0 && n_leaf > 0) {
        atomicAdd(reinterpret_cast<unsigned long long*>(counts), (unsigned long long)n_leaf);
        atomicAdd(reinterpret_cast<unsigned long long*>(counts) + 1, (unsigned long long)n_group);
    }
}

extern "C" int rrt_bvh8_traverse(const float* box8, const int* child8,
                                 const float* leaf, const float* gbox, const float* org,
                                 const float* dirn, const float* t_max,
                                 float* t_out, int* slot_out, long long* counts, int n,
                                 cudaStream_t stream) {
    if (n <= 0) return 0;
    const int blocks = (n + THREADS - 1) / THREADS;
    bvh8_traverse_kernel<<<blocks, THREADS, 0, stream>>>(
        box8, child8, leaf, gbox, org, dirn, t_max, t_out, slot_out, counts, n);
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
