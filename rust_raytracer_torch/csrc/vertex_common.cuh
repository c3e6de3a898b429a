// Shared by the path vertex kernels (vertex_hit.cu, free_flight.cu,
// vertex_shade.cu, lane_update.cu, pool_refill.cu): 3-vector arithmetic
// in the operation order of the port's core/math.py, the scalar rules of
// PyTorch's CUDA elementwise kernels, and the layout of ops/vertex.py's
// scene tables.
//
// Every source is compiled with -fmad=false, IEEE division and square
// root: each expression below rounds where the plain PyTorch version's
// separate kernels round.  Two rules of PyTorch's CUDA kernels are kept
// by hand: a tensor divided by a Python number is multiplied by the f32
// reciprocal of that number (div_true_kernel_cuda's CPU-scalar path,
// `sdiv`), and clamp, minimum and maximum propagate NaN.
#pragma once

#include <math.h>
#include <stdint.h>

namespace rrt {

struct f3 {
    float x, y, z;
};

__device__ __forceinline__ f3 mk3(float x, float y, float z) { return f3{x, y, z}; }
__device__ __forceinline__ f3 ld3(const float* p) { return f3{p[0], p[1], p[2]}; }
__device__ __forceinline__ void st3(float* p, f3 a) {
    p[0] = a.x;
    p[1] = a.y;
    p[2] = a.z;
}
__device__ __forceinline__ f3 add3(f3 a, f3 b) { return f3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ f3 sub3(f3 a, f3 b) { return f3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ f3 mul3(f3 a, f3 b) { return f3{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ f3 scale3(f3 a, float s) { return f3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ f3 div3(f3 a, float s) { return f3{a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ f3 neg3(f3 a) { return f3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ f3 sel3(bool c, f3 a, f3 b) { return c ? a : b; }

// core/math.py:dot, an explicit x*x + y*y + z*z
__device__ __forceinline__ float dot3(f3 a, f3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float len2(f3 a) { return dot3(a, a); }
__device__ __forceinline__ f3 cross3(f3 a, f3 b) {
    return f3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// torch.clamp / minimum / maximum: NaN in, NaN out
__device__ __forceinline__ float cmin(float x, float lo) { return (x != x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float cmax(float x, float hi) { return (x != x) ? x : fminf(x, hi); }
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
    return cmax(cmin(x, lo), hi);
}
__device__ __forceinline__ float tminimum(float a, float b) {
    return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float tmaximum(float a, float b) {
    return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// tensor / python_number on the card: times the f32 reciprocal
__device__ __forceinline__ float sdiv(float x, float b) { return x * (1.0f / b); }

// core/math.py:length, safe_sqrt, normalize
__device__ __forceinline__ float length3(f3 a) { return sqrtf(len2(a)); }
__device__ __forceinline__ float safe_sqrt(float x) { return sqrtf(cmin(x, (float)1e-20)); }
__device__ __forceinline__ f3 normalize3(f3 a) { return div3(a, length3(a)); }
// normalize(a, 1e-20): the squared length clamped at 1e-40 (a subnormal f32)
__device__ __forceinline__ f3 normalize_eps(f3 a) {
    return div3(a, sqrtf(cmin(len2(a), (float)(1e-20 * 1e-20))));
}

// core/math.py:reflect, refract, reflectance
__device__ __forceinline__ f3 reflect3(f3 v, f3 n) {
    return sub3(v, scale3(n, 2.0f * dot3(v, n)));
}
__device__ __forceinline__ f3 refract3(f3 uv, f3 n, float ratio) {
    const float cos_t = cmax(dot3(neg3(uv), n), 1.0f);
    const f3 r_perp = scale3(add3(uv, scale3(n, cos_t)), ratio);
    const f3 r_par = scale3(n, -safe_sqrt(fabsf(1.0f - len2(r_perp))));
    return add3(r_perp, r_par);
}
__device__ __forceinline__ float reflectance(float cos_t, float ratio) {
    float r0 = (1.0f - ratio) / (1.0f + ratio);
    r0 = r0 * r0;
    const float x = 1.0f - cos_t;
    const float x4 = (x * x) * (x * x);
    return r0 + (1.0f - r0) * (x * x4);
}

// core/math.py:onb_from_vec and onb_transform
__device__ __forceinline__ void onb(f3 w, f3* u, f3* v) {
    const float use_y = (fabsf(w.x) > (float)0.9) ? 1.0f : 0.0f;
    const f3 a = f3{1.0f - use_y, use_y, 0.0f};
    *v = normalize3(cross3(w, a));
    *u = cross3(w, *v);
}
__device__ __forceinline__ f3 onb_apply(f3 u, f3 v, f3 w, f3 l) {
    return add3(add3(scale3(u, l.x), scale3(v, l.y)), scale3(w, l.z));
}

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

constexpr double PI = 3.141592653589793;

// ---- the scene tables of ops/vertex.py:vertex_tables (keep in step) ----
// itab[0:HEADER] holds the counts and the offsets of each table's rows in
// ftab (f32) and itab (i32).
enum Header {
    H_NS = 0, H_AFFINE, H_NP, H_NT, H_NVOL, H_NSKY, H_NSUN, H_NMAT, H_NLIGHT, H_NNODE,
    H_NPROXY,
    H_F_SPH, H_F_PLN, H_F_SUN, H_F_MAT, H_F_PROXY, H_F_CONST, H_F_NODE, H_F_BG,
    H_I_SPH, H_I_PLN, H_I_VOL, H_I_MAT, H_I_LIGHT, H_I_NODE, H_F_VOL, H_I_VOLK, H_I_CLOS,
    H_NBVH, H_F_BVH, H_I_BVH,
    HEADER = 32
};
// row widths: sphere center(3) radius inv(9) fwd(9) | mat; plane corner
// uhalf vhalf dual_u dual_v normal (3 each) area | backface mat; material
// inv_ior ior | type; light | kind idx;
// proxy sphere center radius; texture node scale | kind c0 c1 c2 a b c d;
// volume center(3) axes(9) halfsize(3) neg_inv_density | kind, the offset
// in ftab and the count of its mesh block's rows (v0 e1 e2, 9 floats each);
// texture closure (one a material, then a sky, then a sun: the only
// record of the texture roots) | the offset in itab of its entries, their
// count, the positions of its albedo, roughness, normal-map and emission
// roots (-1 where none); closure entry | node, the positions of its
// children c0 c1 c2 in the closure
enum Rows {
    SPH_F = 22, SPH_I = 1, PLN_F = 19, PLN_I = 2, SUN_F = 3, MAT_F = 2, MAT_I = 1,
    LIGHT_I = 2, PROXY_F = 4, NODE_F = 1, NODE_I = 8, TRI_ATTR = 32, VOL_F = 16, VOL_I = 3,
    CLOS_I = 6, CLOS_E = 4
};
// the spheres' BVH (ops/vertex.py:sphere_bvh): a node's f32 row (at
// H_F_BVH, float4-aligned) is lo(3) hi(3) ctr(3) beta gamma 0, its margin
// for a ray from o beta |o - ctr|^2 + gamma; its i32 row (at H_I_BVH) the
// children (left, right), or (-1 - first, count) of a leaf, whose sphere
// ids are at H_I_BVH + BVH_I * H_NBVH + first in leaf order
enum SphereBvh { BVH_F = 12, BVH_I = 2, BVH_STACK = 32 };
// ops/texture.py node kinds, scene/pack.py ids
enum TexKind { CONSTANT = 0, CHECKER, CHECKER_SOLID, IMAGE, LERP, NOISE_SOLID, CHANNEL,
               UV_DEBUG };
enum Prim { PRIM_NONE = 0, PRIM_SPHERE, PRIM_PLANE, PRIM_TRIANGLE, PRIM_VOLUME, PRIM_SKY,
            PRIM_SUN };
enum Mat { MAT_LAMBERTIAN = 0, MAT_METAL, MAT_DIELECTRIC, MAT_GLOSSY, MAT_EMISSIVE,
           MAT_ISOTROPIC, MAT_NORMAL_DEBUG };
enum Light { LIGHT_SPHERE = 0, LIGHT_PLANE, LIGHT_SKY, LIGHT_SUN, LIGHT_PROXY };
// the longest texture closure the shading kernel takes (ops/vertex.py:MAX_NODES)
constexpr int MAX_NODES = 32;

// ops/intersect.py:plane_hit -> t, inf on a miss (u, v are not needed)
__device__ __forceinline__ float plane_hit_t(f3 o, f3 d, const float* r, bool backface,
                                             float t_min, float t_max) {
    const f3 corner = ld3(r), dual_u = ld3(r + 9), dual_v = ld3(r + 12), nrm = ld3(r + 15);
    const float det_eps = (float)1e-12;
    const float dot_rn = dot3(nrm, d);
    const float dd = backface ? fabsf(dot_rn) : -dot_rn;
    const bool facing = dd > det_eps;
    const float denom = fabsf(dot_rn) > det_eps ? dot_rn : 1.0f;
    const float t = dot3(nrm, sub3(corner, o)) / denom;
    const bool in_t = facing && t > t_min && t < t_max;
    const float t_uvsafe = in_t ? t : 1.0f;
    const f3 pos = add3(o, scale3(d, t_uvsafe));
    const f3 local = sub3(pos, corner);
    const float u = dot3(local, dual_u);
    const float v = dot3(local, dual_v);
    const bool in_uv = u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f;
    return (in_t && in_uv) ? t : f_inf();
}

// 3x3 row-major m times v, in the order of the plain version's products
// on the card (the affine spheres' rows; scripts/matvec_order.py finds the
// orders, scripts/vertex_parity.py's affine set holds the kernels to them).
// `(n, 3) @ m.T` (a cuBLAS gemm) sums each row as one fma chain:
__device__ __forceinline__ float dot_mm(const float* r, f3 v) {
    return fmaf(r[2], v.z, fmaf(r[1], v.y, r[0] * v.x));
}
__device__ __forceinline__ f3 matvec_mm(const float* m, f3 v) {
    return f3{dot_mm(m, v), dot_mm(m + 3, v), dot_mm(m + 6, v)};
}
// einsum("nij,nj->ni") (a batched cuBLAS gemm) chains the first two and
// adds the third product:
__device__ __forceinline__ float dot_bmm(const float* r, f3 v) {
    return fmaf(r[1], v.y, r[0] * v.x) + r[2] * v.z;
}
__device__ __forceinline__ f3 matvec_bmm(const float* m, f3 v) {
    return f3{dot_bmm(m, v), dot_bmm(m + 3, v), dot_bmm(m + 6, v)};
}

}  // namespace rrt
