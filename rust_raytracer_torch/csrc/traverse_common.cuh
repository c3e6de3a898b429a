// Device helpers shared by the traversal kernels (bvh8_traverse.cu,
// threaded_traverse.cu, wf_cull.cu).
//
// Arithmetic follows the reference kernels operation for operation; the
// library is built with -fmad=false and without --use_fast_math (no FMA
// contraction, IEEE division), so every t equals the plain PyTorch
// version's (ops/threaded.py:mt_rows) for the same triangle.

#pragma once

#include <cuda_runtime.h>

namespace rrt {

constexpr int kCluster = 128;          // triangle slots per leaf cluster
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kDetEps = 1e-12f;
constexpr float kTMin = 1e-3f;         // T_MIN_STATIC (camera.rs:294)
constexpr float kBig = 3.4e38f;        // +inf t_max clamps to this

// min/max that propagate NaN as jnp.minimum/maximum do (CUDA's fminf/fmaxf
// drop it): a box whose slab product is NaN (zero direction component with
// the origin on the slab plane) is rejected, as in the reference.
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}

// Möller–Trumbore of one ray against one triangle row, its three float4
// r0, r1, r2 (v0, e1, e2, hit_back, 0, 0).  Returns t where the slot is
// hit with T_MIN < t < best, else +inf.
__device__ __forceinline__ float mt_row(float4 r0, float4 r1, float4 r2,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz, float best) {
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
    const bool ok = (dd > kDetEps) && (u >= 0.0f) && (u <= 1.0f) &&
                    (w >= 0.0f) && (u + w <= 1.0f) &&
                    (t > kTMin) && (t < best);
    return ok ? t : __int_as_float(0x7f800000);
}

// mt_row of the row at `row`.
__device__ __forceinline__ float mt_slot(const float4* __restrict__ row,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz, float best) {
    return mt_row(__ldg(row), __ldg(row + 1), __ldg(row + 2), ox, oy, oz, dx, dy, dz, best);
}

// The leaf test of the threaded walk (threaded_traverse.cu; the BVH8 walk
// tests only the groups of slots its ray enters, bvh8_traverse.cu), done
// by the whole warp.  Every lane of
// the warp calls it in the same iteration of its walk loop; a lane whose
// step landed on a leaf passes pending = true and that cluster's id.  For
// each pending lane in turn, lowest lane first, its ray, best t and cluster
// go to all 32 lanes; lane k tests slots k, k + 32, k + 64, k + 96 (their
// rows read coalesced) and keeps its lowest-slot best; a 5-step butterfly
// takes the lexicographic minimum of (t, slot); the owning lane accepts it
// only if it is strictly below its best t.
//
// That equals the sequential scan of the 128 slots with a strict `<`: the
// least t among slots with t < best, the lowest slot at that t, and a later
// cluster wins only when strictly closer.  Each (ray, triangle) t is
// computed by the same operations, so it is bit for bit the same.
__device__ __forceinline__ void warp_leaf_test(const float* __restrict__ tri,
                                               bool pending, int cluster,
                                               float ox, float oy, float oz,
                                               float dx, float dy, float dz,
                                               float& best_t, int& best_i) {
    const int lane = threadIdx.x & (kWarp - 1);
    unsigned todo = __ballot_sync(kFullMask, pending);
    while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int c = __shfl_sync(kFullMask, cluster, src);
        const float sox = __shfl_sync(kFullMask, ox, src);
        const float soy = __shfl_sync(kFullMask, oy, src);
        const float soz = __shfl_sync(kFullMask, oz, src);
        const float sdx = __shfl_sync(kFullMask, dx, src);
        const float sdy = __shfl_sync(kFullMask, dy, src);
        const float sdz = __shfl_sync(kFullMask, dz, src);
        const float sbest = __shfl_sync(kFullMask, best_t, src);
        const float4* rows = reinterpret_cast<const float4*>(tri) + (size_t)c * kCluster * 3;

        float t = __int_as_float(0x7f800000);
        int slot = kCluster;
#pragma unroll
        for (int j = 0; j < kCluster / kWarp; ++j) {
            const int k = lane + kWarp * j;
            const float tk = mt_slot(rows + 3 * k, sox, soy, soz, sdx, sdy, sdz, sbest);
            if (tk < t) {  // strict: the lane's lowest slot at equal t
                t = tk;
                slot = k;
            }
        }
#pragma unroll
        for (int m = kWarp / 2; m > 0; m >>= 1) {
            const float ot = __shfl_xor_sync(kFullMask, t, m);
            const int os = __shfl_xor_sync(kFullMask, slot, m);
            if (ot < t || (ot == t && os < slot)) {
                t = ot;
                slot = os;
            }
        }
        if (lane == src && t < best_t) {
            best_t = t;
            best_i = c * kCluster + slot;
        }
    }
}

}  // namespace rrt
