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
// (24 bytes) and its alive flag, walks the spheres' BVH (ops/vertex.py:
// sphere_bvh, in the scene table: a binary tree, median splits, at most 4
// spheres a leaf, a few KB served from L1/L2 to every lane), loops over
// every plane, and writes (t, id) of the nearest sphere and plane and the
// triangle walk's t_max once (20 bytes).  A sphere's arithmetic is the
// plain version's, operation for operation, so (t, id) are equal bit for
// bit; an affine sphere's (org - c) @ inv.T sums in the order of the
// card's matmul (vertex_common.cuh:matvec_mm).
//
// The walk.  At an inner node the lane tests both children's boxes and
// goes on into the nearer, pushing the other with its entry t on a stack
// in registers (local memory); at a leaf it tests each sphere; it pops past
// a node whose entry t has come to exceed its best t (`>`: a node entered
// at the best t is walked, for a sphere there of equal t and lower id).  A
// box is entered where the slabs of the box, widened by the lane's margin,
// overlap [t_min, best]: the margin (beta |o - ctr|^2 + gamma, from the
// node's row) bounds how far outside its sphere a computed root can lie
// (~14 eps |o - c|^2 / r near a tangent, where the discriminant's rounding
// is amplified by the square root), and the slab ends are moved out by
// 2^-20 of themselves for their own rounding, so no sphere whose root is
// at most the best t is ever culled.  A NaN slab keeps the node.
//
// The winner.  The loop keeps the least t, the lowest index at equal t: a
// sphere si replaces the best when t < best, t being root1 if disc >= 0 and
// t_min < root1 < best, else root2 on the same terms, else inf.  The walk
// meets the spheres out of index order, so it computes each sphere's
// candidate without the best (root1 if disc >= 0 and root1 > t_min, else
// root2 on those terms, else inf) and keeps the least (t, id).  That is the
// same: root1 <= root2 (the numerators differ by +-sq >= 0 and a > 0
// divides both, and rounding is monotone), so where root1 is a candidate
// but not below the best neither is root2, and the loop's t is the
// candidate exactly when the candidate is below the best, inf otherwise.
// The loop's result is then the least candidate at its lowest index, which
// is the least (t, id); a NaN root is never a candidate, an inf one never
// wins.  A scene of at most one leaf of spheres walks that one leaf: the
// loop.
//
// What bounds it: bytes, ~45 a lane (0.0035 ms at 2^18 lanes by 3.35 TB/s)
// with a handful of primitives; with many spheres, the walk's f32 operations
// (~40 a box, two boxes a node entered, ~40 a sphere test; golden_monkey's
// 461 spheres: ~6 nodes entered and ~2.5-3.3 sphere tests a live lane,
// against 461 tests in the loop) and the warp's divergence between walks
// (its mid pool step: 0.059 ms against 0.0035 by bytes, on an H100); with
// many planes, their ~50 operations each.
#include <cuda_runtime.h>
#include <stdint.h>

#include "vertex_common.cuh"

using namespace rrt;

#define THREADS 256

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
// the slab ends moved out by 2^-20 of themselves (their rounding is ~3 ulps)
constexpr float kOut = 1.0f + 1.0f / 1048576.0f;
constexpr float kIn = 1.0f - 1.0f / 1048576.0f;
// a direction component this small is taken as this, signed: no 0 x inf
constexpr float kTinyDir = 7.888609052210118e-31f;  // 2^-100

// intersect_spheres' arithmetic for sphere row r, without the running best:
// root1 if disc >= 0 and root1 > t_min, else root2 on those terms, else inf
__device__ __forceinline__ float sphere_candidate(const float* r, f3 o, f3 d, float a_plain,
                                                  bool affine, float t_min) {
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
    return (ok && root1 > t_min) ? root1 : ((ok && root2 > t_min) ? root2 : f_inf());
}

// Does the ray enter node row `row` (lo hi ctr beta gamma, float4-aligned)
// widened by its margin within [t_min, best]?  *enter: where (>= t_min).
__device__ __forceinline__ bool node_enter(const float* row, f3 o, f3 inv, float t_min,
                                           float best, float* enter) {
    const float4 p0 = __ldg(reinterpret_cast<const float4*>(row));
    const float4 p1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
    const float4 p2 = __ldg(reinterpret_cast<const float4*>(row) + 2);
    const f3 oc = mk3(o.x - p1.z, o.y - p1.w, o.z - p2.x);
    const float m = p2.y * len2(oc) + p2.z;
    const float x0 = (p0.x - m - o.x) * inv.x, x1 = (p0.w + m - o.x) * inv.x;
    const float y0 = (p0.y - m - o.y) * inv.y, y1 = (p1.x + m - o.y) * inv.y;
    const float z0 = (p0.z - m - o.z) * inv.z, z1 = (p1.y + m - o.z) * inv.z;
    float near = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
    float far = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
    near *= near >= 0.0f ? kIn : kOut;
    far *= far >= 0.0f ? kOut : kIn;
    *enter = fmaxf(near, t_min);  // a NaN end drops out of fmaxf / fminf
    return *enter <= fminf(far, best);
}

__device__ __forceinline__ float safe_inv(float d) {
    return 1.0f / (fabsf(d) >= kTinyDir ? d : copysignf(kTinyDir, d));
}

}  // namespace

// counts: null, or (2,) i64 += node visits, sphere tests of the lanes of
// `alive` (all where it is null), one atomic a warp each
__global__ void __launch_bounds__(THREADS)
vertex_hit_kernel(const float* __restrict__ ftab, const int* __restrict__ itab,
                  const float* __restrict__ org, const float* __restrict__ dirn,
                  const unsigned char* __restrict__ alive, long long* __restrict__ counts,
                  float* __restrict__ t_sph, int* __restrict__ i_sph, float* __restrict__ t_pln,
                  int* __restrict__ i_pln, float* __restrict__ tri_tmax, int n, float t_min) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool valid = i < n;
    const bool live = valid && (alive == nullptr || alive[i]);
    unsigned visits = 0, tests = 0;

    if (valid) {
        const f3 o = ld3(org + 3 * i), d = ld3(dirn + 3 * i);

        // ---- spheres (intersect_spheres): the walk of their BVH ----
        const int ns = itab[H_NS];
        const bool affine = itab[H_AFFINE] != 0;
        const float* sph = ftab + itab[H_F_SPH];
        const float* node_f = ftab + itab[H_F_BVH];
        const int* node_i = itab + itab[H_I_BVH];
        const int* leaf_ids = node_i + BVH_I * itab[H_NBVH];
        const float a_plain = len2(d);
        const f3 inv = mk3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
        float best_t = f_inf();
        int best_i = -1;
        int stack_node[BVH_STACK];
        float stack_t[BVH_STACK];
        int sp = 0;
        int node = ns > 0 ? 0 : -1;
        while (node >= 0) {
            ++visits;
            const int2 kids = __ldg(reinterpret_cast<const int2*>(node_i) + node);
            if (kids.x < 0) {
                const int first = -1 - kids.x;
                for (int k = 0; k < kids.y; ++k) {
                    const int si = __ldg(leaf_ids + first + k);
                    const float t = sphere_candidate(sph + si * SPH_F, o, d, a_plain, affine,
                                                     t_min);
                    if (t < best_t || (t == best_t && si < best_i)) {
                        best_t = t;
                        best_i = si;
                    }
                }
                tests += kids.y;
                node = -1;
            } else {
                float el, er;
                const bool in_l = node_enter(node_f + kids.x * BVH_F, o, inv, t_min, best_t, &el);
                const bool in_r = node_enter(node_f + kids.y * BVH_F, o, inv, t_min, best_t, &er);
                if (in_l && in_r) {
                    const bool left_first = el <= er;
                    node = left_first ? kids.x : kids.y;
                    stack_node[sp] = left_first ? kids.y : kids.x;
                    stack_t[sp++] = left_first ? er : el;
                } else {
                    node = in_l ? kids.x : (in_r ? kids.y : -1);
                }
            }
            while (node < 0 && sp > 0) {
                --sp;
                if (!(stack_t[sp] > best_t)) node = stack_node[sp];
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

    if (counts != nullptr) {
        const unsigned v = __reduce_add_sync(kFullMask, live ? visits : 0u);
        const unsigned s = __reduce_add_sync(kFullMask, live ? tests : 0u);
        if ((threadIdx.x & 31) == 0 && v > 0) {
            atomicAdd(reinterpret_cast<unsigned long long*>(counts), (unsigned long long)v);
            atomicAdd(reinterpret_cast<unsigned long long*>(counts) + 1, (unsigned long long)s);
        }
    }
}

// ftab, itab: ops/vertex.py:vertex_tables; org, dirn (n, 3) f32; alive (n,)
// bool or NULL; counts (2,) i64 or NULL; out: t_sph, i_sph, t_pln, i_pln,
// tri_tmax (n,)
extern "C" int rrt_vertex_hit(const void* ftab, const void* itab, const void* org,
                              const void* dirn, const void* alive, void* counts, void* t_sph,
                              void* i_sph, void* t_pln, void* i_pln, void* tri_tmax, long long n,
                              float t_min, cudaStream_t stream) {
    const int blocks = (int)((n + THREADS - 1) / THREADS);
    vertex_hit_kernel<<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(ftab), static_cast<const int*>(itab),
        static_cast<const float*>(org), static_cast<const float*>(dirn),
        static_cast<const unsigned char*>(alive), static_cast<long long*>(counts),
        static_cast<float*>(t_sph), static_cast<int*>(i_sph), static_cast<float*>(t_pln),
        static_cast<int*>(i_pln), static_cast<float*>(tri_tmax), (int)n, t_min);
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
