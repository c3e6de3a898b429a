// KV1 of the path vertex: the closest analytic hit on the card.
//
// Replaces, in the port, ops/intersect.py:intersect_spheres, intersect_planes
// and the first lines of _intersect (t_min, the t_max the triangle walk gets:
// the nearer of the sphere and plane hits, 0 on a dead lane); in the
// reference these are XLA fusions of the jitted step
// (rust_raytracer_tpu/ops/intersect.py:113, :226, :611), not a Pallas
// kernel.  The plain version is that torch-ops code, which the CPU runs
// and chip_smoke.py holds this kernel against.
//
// Design: one thread a lane, 256 lanes a block.  A lane reads its ray once
// (24 bytes) and its alive flag, loops over every sphere and then every
// plane of the scene table (ops/vertex.py:vertex_tables; a few hundred
// bytes, served from L1/L2 to every lane), and writes (t, id) of the
// nearest sphere and plane and the triangle walk's t_max once (20 bytes).
// The arithmetic is the plain version's, operation for operation, so
// (t, id) are equal bit for bit; an affine sphere's (org - c) @ inv.T sums
// in the order of the card's matmul (vertex_common.cuh:matvec_mm).
//
// What bounds it: bytes, ~45 a lane (0.0035 ms at 2^18 lanes by 3.35 TB/s)
// with a handful of primitives; with many spheres or planes, their f32
// operations (~40 a sphere, ~50 a plane, a lane) over 67 TFLOP/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "vertex_common.cuh"

using namespace rrt;

#define THREADS 256

__global__ void __launch_bounds__(THREADS)
vertex_hit_kernel(const float* __restrict__ ftab, const int* __restrict__ itab,
                  const float* __restrict__ org, const float* __restrict__ dirn,
                  const unsigned char* __restrict__ alive, float* __restrict__ t_sph,
                  int* __restrict__ i_sph, float* __restrict__ t_pln, int* __restrict__ i_pln,
                  float* __restrict__ tri_tmax, int n, float t_min) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const f3 o = ld3(org + 3 * i), d = ld3(dirn + 3 * i);

    // ---- spheres (intersect_spheres), running closest hit ----
    const int ns = itab[H_NS];
    const bool affine = itab[H_AFFINE] != 0;
    const float* sph = ftab + itab[H_F_SPH];
    float best_t = f_inf();
    int best_i = -1;
    const float a_plain = len2(d);
    for (int si = 0; si < ns; ++si) {
        const float* r = sph + si * SPH_F;
        float a, half_b, c;
        if (affine) {
            const f3 oc = matvec_mm(r + 4, sub3(o, ld3(r)));
            const f3 dl = matvec_mm(r + 4, d);
            a = len2(dl);
            half_b = dot3(dl, oc);
            c = len2(oc) - 1.0f;
        } else {
            const f3 oc = sub3(o, ld3(r));
            a = a_plain;
            half_b = dot3(d, oc);
            c = len2(oc) - r[3] * r[3];
        }
        const float disc = half_b * half_b - a * c;
        const float sq = sqrtf(cmin(disc, 0.0f));
        const float root1 = (-half_b - sq) / a;
        const float root2 = (-half_b + sq) / a;
        const bool ok = disc >= 0.0f;
        const bool v1 = ok && root1 > t_min && root1 < best_t;
        const bool v2 = ok && root2 > t_min && root2 < best_t;
        const float t = v1 ? root1 : (v2 ? root2 : f_inf());
        if (t < best_t) {
            best_t = t;
            best_i = si;
        }
    }

    // ---- planes (intersect_planes) ----
    const int np = itab[H_NP];
    const float* pln = ftab + itab[H_F_PLN];
    const int* pln_i = itab + itab[H_I_PLN];
    float best_tp = f_inf();
    int best_ip = -1;
    for (int pi = 0; pi < np; ++pi) {
        const float t = plane_hit_t(o, d, pln + pi * PLN_F, pln_i[pi * PLN_I] != 0, t_min,
                                    best_tp);
        if (t < best_tp) {
            best_tp = t;
            best_ip = pi;
        }
    }

    t_sph[i] = best_t;
    i_sph[i] = best_i;
    t_pln[i] = best_tp;
    i_pln[i] = best_ip;
    const float tmax = tminimum(best_t, best_tp);
    tri_tmax[i] = (alive == nullptr || alive[i]) ? tmax : 0.0f;
}

// ftab, itab: ops/vertex.py:vertex_tables; org, dirn (n, 3) f32; alive (n,)
// bool or NULL; out: t_sph, i_sph, t_pln, i_pln, tri_tmax (n,)
extern "C" int rrt_vertex_hit(const void* ftab, const void* itab, const void* org,
                              const void* dirn, const void* alive, void* t_sph, void* i_sph,
                              void* t_pln, void* i_pln, void* tri_tmax, long long n,
                              float t_min, cudaStream_t stream) {
    const int blocks = (int)((n + THREADS - 1) / THREADS);
    vertex_hit_kernel<<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(ftab), static_cast<const int*>(itab),
        static_cast<const float*>(org), static_cast<const float*>(dirn),
        static_cast<const unsigned char*>(alive), static_cast<float*>(t_sph),
        static_cast<int*>(i_sph), static_cast<float*>(t_pln), static_cast<int*>(i_pln),
        static_cast<float*>(tri_tmax), (int)n, t_min);
    return (int)cudaGetLastError();
}

extern "C" int rrt_vertex_hit_attrs(int* out) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, vertex_hit_kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    return 0;
}
