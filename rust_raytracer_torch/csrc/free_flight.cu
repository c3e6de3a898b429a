// KV-FF of the path vertex: the hit merge and the volumes' free flight, on
// the card, between the triangle walk (or KV1, in a scene without
// triangles) and KV2.
//
// Replaces, in the port, ops/intersect.py:merge_volumes on the card in a
// scene with volumes: the closest of the sphere, plane and triangle hits,
// then intersect_volumes with each volume's _volume_boundary_span and its
// pcg4d draw (core/rng.py) -> (t, kind, prim), which KV2 takes as its
// merged hit.  It replaces no Pallas kernel: the JAX package leaves the
// free flight to XLA's fusion of the jitted step
// (rust_raytracer_tpu/ops/intersect.py:505-601).  The plain version is that
// torch-ops code, which stays: the CPU, a float64 pack and the
// differentiable trace run it, and scripts/free_flight_check.py holds this
// kernel against it.
//
// Design: one thread a lane, 256 lanes a block.  A lane reads its ray, the
// six hit fields and its RNG key once, keeps every intermediate of the
// plain version's ~190 torch ops in registers (the merge, then for each
// volume in order its boundary span, one pcg4d draw and a log), and writes
// (t, kind, prim) once.  Each volume's boundary code is picked by its kind,
// the same for every lane, so a warp does not diverge on it; a convex mesh
// boundary is two loops over its triangles (the nearest crossing, then the
// nearest beyond it), in registers, with no chunking.  The volume rows
// (centre, axes, half-size, -1/density; kind and the mesh block's offset
// and count) are in ops/vertex.py's tables, built before any capture.
//
// Arithmetic: the plain version's, operation for operation (-fmad=false,
// IEEE division and sqrt, torch's NaN-propagating minimum, maximum, amin,
// amax and clamp; `1.0 / x` is a reciprocal), so (t, kind, prim) are equal
// bit for bit.  The box and ellipsoid rows' (org - c) @ axes.T and
// dirn @ axes.T sum in the order of the card's matmul
// (vertex_common.cuh:matvec_mm, found by scripts/matvec_order.py).
//
// What bounds it: bytes.  A lane moves 84 (ray 24, the six hit fields 24,
// pixel, sample and bounce 24 in; t, kind and prim 12 out): 0.0066 ms at
// 2^18 lanes by 3.35 TB/s.  The benchmark's free-flight roofline counts 60
// a live lane (the merged t in place of the six hit fields), ~0.0046 ms a
// step.  Its arithmetic, ~250 f32 and u32 operations a lane and box
// volume, is ~0.001 ms at 67 TFLOP/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pcg4d.cuh"
#include "vertex_common.cuh"

using namespace rrt;

#define THREADS 256

namespace {

// scene/pack.py boundary kinds
enum VolKind { VOL_SPHERE = 0, VOL_BOX = 1, VOL_MESH = 2 };

// torch's amax / amin over three values: NaN in, NaN out
__device__ __forceinline__ float amax3(float a, float b, float c) {
    return tmaximum(tmaximum(a, b), c);
}
__device__ __forceinline__ float amin3(float a, float b, float c) {
    return tminimum(tminimum(a, b), c);
}

// ops/intersect.py:_mesh_crossings for one triangle row (v0, e1, e2)
__device__ __forceinline__ float mesh_crossing(const float* r, f3 o, f3 d) {
    const f3 v0 = ld3(r), e1 = ld3(r + 3), e2 = ld3(r + 6);
    const f3 pvec = cross3(d, e2);
    const float det = dot3(e1, pvec);
    const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
    const f3 bvec = sub3(o, v0);
    const float u = dot3(bvec, pvec) * inv_det;
    const f3 qvec = cross3(bvec, e1);
    const float w = dot3(d, qvec) * inv_det;
    const float tt = dot3(e2, qvec) * inv_det;
    const bool ok = fabsf(det) > (float)1e-12 && u >= 0.0f && u <= 1.0f && w >= 0.0f
                    && u + w <= 1.0f;
    return ok ? tt : f_inf();
}

// ops/intersect.py:_volume_boundary_span of volume row `vf` (VOL_F floats)
// of kind `kind` -> enter, exit; returns valid
__device__ __forceinline__ bool boundary_span(int kind, const float* vf, const float* tri,
                                              int n_tri, f3 o, f3 d, float* enter,
                                              float* exit_) {
    if (kind == VOL_MESH) {
        float lo = f_inf();
        for (int k = 0; k < n_tri; ++k) lo = tminimum(lo, mesh_crossing(tri + 9 * k, o, d));
        const float floor_ = lo + (float)1e-6;
        float hi = f_inf();
        for (int k = 0; k < n_tri; ++k) {
            const float ts = mesh_crossing(tri + 9 * k, o, d);
            hi = tminimum(hi, ts > floor_ ? ts : f_inf());
        }
        const bool valid = isfinite(lo) && isfinite(hi);
        *enter = valid ? lo : 0.0f;
        *exit_ = valid ? hi : 0.0f;
        return valid;
    }
    const float* axes = vf + 3;
    const f3 oc = matvec_mm(axes, sub3(o, ld3(vf)));
    const f3 dl = matvec_mm(axes, d);
    if (kind == VOL_SPHERE) {
        const float a = len2(dl);
        const float half_b = dot3(dl, oc);
        const float c = len2(oc) - 1.0f;
        const float disc = half_b * half_b - a * c;
        const float sq = sqrtf(cmin(disc, 0.0f));
        const float a_safe = a == 0.0f ? 1.0f : a;
        *enter = (-half_b - sq) / a_safe;
        *exit_ = (-half_b + sq) / a_safe;
        return disc > 0.0f;
    }
    const f3 half = ld3(vf + 12);
    const f3 inv = mk3(1.0f / dl.x, 1.0f / dl.y, 1.0f / dl.z);
    const f3 t0 = mul3(sub3(neg3(half), oc), inv);
    const f3 t1 = mul3(sub3(half, oc), inv);
    *enter = amax3(tminimum(t0.x, t1.x), tminimum(t0.y, t1.y), tminimum(t0.z, t1.z));
    *exit_ = amin3(tmaximum(t0.x, t1.x), tmaximum(t0.y, t1.y), tmaximum(t0.z, t1.z));
    return *enter < *exit_;
}

}  // namespace

// ftab, itab: ops/vertex.py:vertex_tables (H_F_VOL, H_I_VOLK rows); org,
// dirn (n, 3) f32; t_sph, i_sph, t_pln, i_pln, t_tri, i_tri (n,) f32 / i32;
// pixel, sample (n,) int64; bounce (n,) int64 with bounce_stride 1, or one
// int64 (stride 0), or NULL and bounce_val; seed one int64 or NULL and
// seed_val.  Out: t (n,) f32, kind and prim (n,) i32.
__global__ void __launch_bounds__(THREADS)
free_flight_kernel(const float* __restrict__ ftab, const int* __restrict__ itab,
                   const float* __restrict__ org, const float* __restrict__ dirn,
                   const float* __restrict__ t_sph, const int* __restrict__ i_sph,
                   const float* __restrict__ t_pln, const int* __restrict__ i_pln,
                   const float* __restrict__ t_tri, const int* __restrict__ i_tri,
                   const long long* __restrict__ pixel, const long long* __restrict__ sample,
                   const long long* __restrict__ bounce, const long long* __restrict__ seed,
                   float* __restrict__ t_out, int* __restrict__ kind_out,
                   int* __restrict__ prim_out, int n, int bounce_stride, long long bounce_val,
                   long long seed_val, float t_min) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    // ---- the surface merge (merge_volumes' first lines) ----
    const float ts = t_sph[i], tp = t_pln[i];
    const float tt = i_tri[i] >= 0 ? t_tri[i] : f_inf();
    float t = tminimum(tminimum(ts, tp), tt);
    const bool is_s = ts <= t, is_p = tp <= t;
    int kind = is_s ? PRIM_SPHERE : (is_p ? PRIM_PLANE : PRIM_TRIANGLE);
    int prim = is_s ? i_sph[i] : (is_p ? i_pln[i] : i_tri[i]);
    if (!isfinite(t)) {
        kind = PRIM_NONE;
        prim = -1;
    }

    // ---- the volumes' free flight (intersect_volumes) ----
    const f3 o = ld3(org + 3 * i), d = ld3(dirn + 3 * i);
    const Ctx ctx{(uint32_t)pixel[i], (uint32_t)sample[i],
                  (uint32_t)(bounce ? bounce[(long long)i * bounce_stride] : bounce_val),
                  (uint32_t)(seed ? seed[0] : seed_val)};
    const int nvol = itab[H_NVOL];
    const float* vrow = ftab + itab[H_F_VOL];
    const int* vkind = itab + itab[H_I_VOLK];
    const float ray_len = length3(d);
    float best_t = t;
    int best_i = -1;
    for (int vi = 0; vi < nvol; ++vi) {
        const float* vf = vrow + vi * VOL_F;
        const int* vk = vkind + vi * VOL_I;
        float enter, exit_;
        const bool valid = boundary_span(vk[0], vf, ftab + vk[1], vk[2], o, d, &enter, &exit_);
        const float lo = cmin(tmaximum(enter, t_min), 0.0f);
        const float hi = tminimum(exit_, best_t);
        const bool inside = valid && lo < hi;
        const float dist_inside = (hi - lo) * ray_len;
        const float u = uniform1(ctx, VOLUME + 16u * (uint32_t)vi);
        const float hit_dist = vf[15] * logf(cmin(u, (float)1e-30));
        const float tv = lo + hit_dist / ray_len;
        if (inside && hit_dist <= dist_inside) {
            best_i = vi;
            best_t = tv;
        }
    }
    if (best_i >= 0) {
        t = best_t;
        kind = PRIM_VOLUME;
        prim = best_i;
    }
    t_out[i] = t;
    kind_out[i] = kind;
    prim_out[i] = prim;
}

extern "C" int rrt_free_flight(const void* ftab, const void* itab, const void* org,
                               const void* dirn, const void* t_sph, const void* i_sph,
                               const void* t_pln, const void* i_pln, const void* t_tri,
                               const void* i_tri, const void* pixel, const void* sample,
                               const void* bounce, const void* seed, void* t_out,
                               void* kind_out, void* prim_out, long long n,
                               long long bounce_stride, long long bounce_val,
                               long long seed_val, float t_min, cudaStream_t stream) {
    const int blocks = (int)((n + THREADS - 1) / THREADS);
    free_flight_kernel<<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(ftab), static_cast<const int*>(itab),
        static_cast<const float*>(org), static_cast<const float*>(dirn),
        static_cast<const float*>(t_sph), static_cast<const int*>(i_sph),
        static_cast<const float*>(t_pln), static_cast<const int*>(i_pln),
        static_cast<const float*>(t_tri), static_cast<const int*>(i_tri),
        static_cast<const long long*>(pixel), static_cast<const long long*>(sample),
        static_cast<const long long*>(bounce), static_cast<const long long*>(seed),
        static_cast<float*>(t_out), static_cast<int*>(kind_out), static_cast<int*>(prim_out),
        (int)n, (int)bounce_stride, bounce_val, seed_val, t_min);
    return (int)cudaGetLastError();
}

extern "C" int rrt_free_flight_attrs(int* out) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, free_flight_kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    return 0;
}
