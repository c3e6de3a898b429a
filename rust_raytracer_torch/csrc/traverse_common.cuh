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

// Möller–Trumbore of one ray against the 128 triangle slots of `cluster`
// (tri: (n_clusters * 128, 12) f32 rows v0, e1, e2, hit_back, 0, 0, read as
// three float4 a slot).  A sequential strict `<` keeps the lowest slot at
// equal t and makes a later cluster win only when strictly closer.
__device__ __forceinline__ void mt_cluster(const float* __restrict__ tri, int cluster,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float& best_t, int& best_i) {
    const float4* rows = reinterpret_cast<const float4*>(tri) + (size_t)cluster * kCluster * 3;
    for (int k = 0; k < kCluster; ++k) {
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
        const bool ok = (dd > kDetEps) && (u >= 0.0f) && (u <= 1.0f) &&
                        (w >= 0.0f) && (u + w <= 1.0f) &&
                        (t > kTMin) && (t < best_t);
        if (ok) {
            best_t = t;
            best_i = cluster * kCluster + k;
        }
    }
}

}  // namespace rrt
