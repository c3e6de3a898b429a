// KV2 of the path vertex: everything after the triangle walk, on the card.
//
// Replaces, in the port: the tail of ops/intersect.py:_intersect (the merge
// of the sphere, plane and triangle hits, then sun and sky),
// ops/intersect.py:hit_attributes, ops/texture.py:eval_program and
// gather_values, ops/shade.py:shade with ops/lights.py:lights_sample and
// lights_pdf_value, and render/integrator.py:shade_hits (its unit normal on
// a miss and the background).  In the reference these are XLA's fusions of
// the jitted step (rust_raytracer_tpu/ops/intersect.py:611-703, :704;
// ops/texture.py:112; ops/shade.py:51; ops/lights.py:101, :122;
// core/rng.py:24, :60), not a Pallas kernel.  The plain version is that
// torch-ops code, which the CPU runs and chip_smoke.py holds this kernel
// against.
//
// Design: one thread a lane, 128 lanes a block.  A lane reads its ray, the
// three hits (or, with volumes, the merged hit that the torch ops of the
// free-flight sample made) and its RNG key once, and writes emission,
// weight, next direction, ended and position once (~44 bytes).  In
// between it works in registers and a small local array: the hit record
// of the one primitive kind it hit, the texture nodes that its shading
// key's roots reach (its material's albedo, roughness and normal map; on
// the sky or the sun, material 0's and the emission), in topological
// order (ops/vertex.py:texture_closures, at most MAX_NODES values: the
// cost does not grow with the scene's materials), the 7-way material on
// only the branch its material takes, and the NEE mixture over the light
// list, each pcg4d draw made where the plain version makes it
// (core/rng.py keys them by stream, so no draw depends on another).  The
// scene is read from ops/vertex.py's flat tables (closures, node kinds,
// constants, image and Perlin data at offsets; material, light, sphere and
// plane rows) and from the pack's tri_attr rows.
//
// Arithmetic: the plain version's, operation for operation (-fmad=false,
// IEEE division and sqrt; a tensor divided by a Python number is a
// multiply by its f32 reciprocal, as PyTorch's CUDA division does), so
// the outputs are equal bit for bit wherever the f32 math functions
// (sinf, cosf, logf, acosf, atan2f) give what PyTorch's kernels give; the
// smoke counts the lanes where they do not.  An affine sphere's 3x3
// products sum in the order of the card's einsum
// (vertex_common.cuh:matvec_bmm).
//
// What bounds it: bytes on cornell_dragon, ~121 a lane plus the 128-byte
// triangle rows its hits gather (0.014 ms at 2^18 lanes by 3.35 TB/s),
// against ~650 f32 operations a lane (the hit record and shading, ~120 a
// light for the NEE sample and pdf, six pcg4d draws); a texture closure
// with Perlin nodes (~1,700 operations a 7-octave node) makes it
// operations.  The branches of a warp's lanes (materials, light picks,
// primitive kinds) run one after another, and the value array sits in
// local memory; both are left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pcg4d.cuh"
#include "vertex_common.cuh"

using namespace rrt;

#define THREADS 128
// slots of the free-flight and the sphere-hit counters: a block's warps
// add to slot blockIdx % VOL_SLOTS, so no one address takes every warp's
// atomic
#define VOL_SLOTS 32

namespace {

struct Scene {
    const float* f;
    const int* i;
    const float* tri;
};

__device__ __forceinline__ int hdr(const Scene& s, int k) { return s.i[k]; }

// one atomic a warp: every lane of the warp that is still here votes
// `flag`, its lowest adds the votes to its block's slot of `slots`
__device__ __forceinline__ void warp_count(unsigned long long* slots, bool flag) {
    const unsigned mask = __activemask();
    const unsigned votes = __ballot_sync(mask, flag);
    if (votes && (int)(threadIdx.x & 31u) == __ffs(mask) - 1)
        atomicAdd(slots + (blockIdx.x & (VOL_SLOTS - 1)), (unsigned long long)__popc(votes));
}

// ---- ops/texture.py ----

__device__ float perlin_sample(f3 p, const float* grad, const int* perm) {
    const f3 pf = mk3(floorf(p.x), floorf(p.y), floorf(p.z));
    const f3 uvw = sub3(p, pf);
    const long long ix0 = (long long)pf.x, iy0 = (long long)pf.y, iz0 = (long long)pf.z;
    const f3 s = mul3(mul3(uvw, uvw),
                      mk3(3.0f - 2.0f * uvw.x, 3.0f - 2.0f * uvw.y, 3.0f - 2.0f * uvw.z));
    float acc = 0.0f;
    for (int di = 0; di < 2; ++di)
        for (int dj = 0; dj < 2; ++dj)
            for (int dk = 0; dk < 2; ++dk) {
                const int ix = (int)((ix0 + di) & 255);
                const int iy = (int)((iy0 + dj) & 255);
                const int iz = (int)((iz0 + dk) & 255);
                const int gidx = perm[ix] ^ perm[256 + iy] ^ perm[512 + iz];
                const f3 g = ld3(grad + 3 * gidx);
                const float fi = (float)di, fj = (float)dj, fk = (float)dk;
                const float w = ((fi * s.x + (float)(1 - di) * (1.0f - s.x))
                                 * (fj * s.y + (float)(1 - dj) * (1.0f - s.y)))
                                * (fk * s.z + (float)(1 - dk) * (1.0f - s.z));
                acc = acc + w * (g.x * (uvw.x - fi) + g.y * (uvw.y - fj)
                                 + g.z * (uvw.z - fk));
            }
    return acc;
}

// ops/texture.py:eval_program on one closure row `clos`: its nodes in
// topological order into val[0, count), a child read at its position in
// the closure; each node's arithmetic the plain version's
__device__ void eval_closure(const Scene& sc, const int* clos, float2 uv, f3 pos, f3* val) {
    const int nn = clos[1];
    const int* ent = sc.i + clos[0];
    const float* cst = sc.f + hdr(sc, H_F_CONST);
    const float* nf = sc.f + hdr(sc, H_F_NODE);
    const int* ni = sc.i + hdr(sc, H_I_NODE);
    for (int p = 0; p < nn; ++p) {
        const int* e = ent + p * CLOS_E;
        const int k = e[0];
        const int* r = ni + k * NODE_I;
        const float scale = nf[k * NODE_F];
        // every node has a constant row: load it beside the node's row,
        // not after its kind is known
        const f3 c = ld3(cst + 3 * k);
        f3 v;
        switch (r[0]) {
        case CONSTANT:
            v = c;
            break;
        case CHECKER: {
            const float inv = 1.0f / scale;
            const long long iu =
                (long long)clamp2((uv.x * 2.0f) * inv, 0.0f, 2147483648.0f);
            const long long iv =
                (long long)clamp2((uv.y * 2.0f) * inv, 0.0f, 2147483648.0f);
            v = ((iu + iv) % 2 == 0) ? val[e[1]] : val[e[2]];
            break;
        }
        case CHECKER_SOLID: {
            const float inv = 1.0f / scale;
            const long long sum = (long long)(int)floorf(pos.x * inv)
                                  + (long long)(int)floorf(pos.y * inv)
                                  + (long long)(int)floorf(pos.z * inv);
            v = (sum % 2 == 0) ? val[e[1]] : val[e[2]];
            break;
        }
        case IMAGE: {
            const float* px = sc.f + r[4];
            const int h = r[5], w = r[6];
            float u = uv.x, vv = uv.y;
            if (r[7]) {  // CLAMP
                u = clamp2(u, 0.0f, 1.0f);
                vv = clamp2(vv, 0.0f, 1.0f);
            } else {
                u = u - floorf(u);
                vv = vv - floorf(vv);
            }
            long long x = (long long)(u * (float)((double)w - 0.001));
            long long y = (long long)(vv * (float)((double)h - 0.001));
            // in range for every finite uv; a NaN uv (where the plain
            // version's gather would raise) reads the first pixel
            x = x < 0 ? 0 : (x >= w ? w - 1 : x);
            y = y < 0 ? 0 : (y >= h ? h - 1 : y);
            v = ld3(px + 3 * (y * w + x));
            break;
        }
        case LERP: {
            const float t = val[e[3]].x;
            const f3 a = val[e[1]], b = val[e[2]];
            v = add3(scale3(a, 1.0f - t), scale3(b, t));
            break;
        }
        case NOISE_SOLID: {
            const float* grad = sc.f + r[4];
            const int* perm = sc.i + r[5];
            const f3 ps = scale3(pos, scale);
            float acc = 0.0f, weight = 1.0f;
            f3 pp = ps;
            for (int o = 0; o < r[6]; ++o) {
                acc = acc + weight * perlin_sample(pp, grad, perm);
                weight *= 0.5f;
                pp = scale3(pp, 2.0f);
            }
            const float turb = fabsf(acc);
            const float s = r[7] == 0 ? 0.5f * (1.0f + sinf(ps.z + 10.0f * turb)) : turb;
            v = mk3(s, s, s);
            break;
        }
        case CHANNEL: {
            const f3 a = val[e[1]];
            const float c = r[4] == 0 ? a.x : (r[4] == 1 ? a.y : a.z);
            v = mk3(c, c, c);
            break;
        }
        default:  // UV_DEBUG
            v = mk3(uv.x, uv.y, 0.5f);
            break;
        }
        val[p] = v;
    }
    if (nn == 0) val[0] = mk3(0.0f, 0.0f, 0.0f);
}

// ---- ops/lights.py ----

__device__ __forceinline__ void light_sphere(const Scene& sc, int kind, int li, f3* c,
                                             float* r) {
    const float* row = kind == LIGHT_PROXY ? sc.f + hdr(sc, H_F_PROXY) + li * PROXY_F
                                           : sc.f + hdr(sc, H_F_SPH) + li * SPH_F;
    *c = ld3(row);
    *r = row[3];
}

// ops/intersect.py:sphere_hit_t with t_min 1e-3, t_max inf
__device__ float sphere_hit_t(f3 o, f3 d, f3 center, float radius) {
    const f3 oc = sub3(o, center);
    const float a = len2(d);
    const float half_b = dot3(d, oc);
    const float c = len2(oc) - radius * radius;
    const float disc = half_b * half_b - a * c;
    const bool ok = disc >= 0.0f;
    float sq = sqrtf(disc > 0.0f ? disc : 1.0f);
    sq = ok ? sq : 0.0f;
    const float root1 = (-half_b - sq) / a;
    const float root2 = (-half_b + sq) / a;
    const float t_min = (float)1e-3;
    const bool v1 = ok && root1 > t_min && root1 < f_inf();
    const bool v2 = ok && root2 > t_min && root2 < f_inf();
    return v1 ? root1 : (v2 ? root2 : f_inf());
}

__device__ float lights_pdf_value(const Scene& sc, f3 o, f3 d) {
    const int nl = hdr(sc, H_NLIGHT);
    const int* lt = sc.i + hdr(sc, H_I_LIGHT);
    float acc = 0.0f;
    for (int s = 0; s < nl; ++s) {
        const int kind = lt[s * LIGHT_I], li = lt[s * LIGHT_I + 1];
        if (kind == LIGHT_SPHERE || kind == LIGHT_PROXY) {
            f3 c;
            float r;
            light_sphere(sc, kind, li, &c, &r);
            const float t = sphere_hit_t(o, d, c, r);
            const bool hits = isfinite(t);
            const float d2 = len2(sub3(c, o));
            const float ctm = safe_sqrt(1.0f - (r * r) / cmin(d2, (float)1e-20));
            const float sa = (float)(2.0 * PI) * (1.0f - ctm);
            const float sa_safe = sa > 0.0f ? sa : 1.0f;
            acc = acc + ((hits && sa > 0.0f) ? 1.0f / sa_safe : 0.0f);
        } else if (kind == LIGHT_PLANE) {
            const float* row = sc.f + hdr(sc, H_F_PLN) + li * PLN_F;
            const bool back = sc.i[hdr(sc, H_I_PLN) + li * PLN_I] != 0;
            const float t = plane_hit_t(o, d, row, back, (float)1e-3, f_inf());
            const bool hits = isfinite(t);
            const float t_safe = hits ? t : 1.0f;
            const float dist2 = (t_safe * t_safe) * len2(d);
            const float dlen = safe_sqrt(len2(d));
            const float cosine = fabsf(dot3(d, ld3(row + 15))) / dlen;
            const float cos_safe = cosine > 0.0f ? cosine : 1.0f;
            const float pdf = dist2 / (cos_safe * row[18]);
            acc = acc + ((hits && cosine > 0.0f) ? pdf : 0.0f);
        } else if (kind == LIGHT_SKY) {
            acc = acc + (float)(1.0 / (4.0 * PI));
        } else {  // LIGHT_SUN
            acc = acc + 1.0f;
        }
    }
    return sdiv(acc, (float)nl);
}

__device__ f3 lights_sample(const Scene& sc, f3 o, const Ctx& ctx) {
    const int nl = hdr(sc, H_NLIGHT);
    if (nl == 0) return mk3(1.0f, 0.0f, 0.0f);
    const int* lt = sc.i + hdr(sc, H_I_LIGHT);
    const float pick_u = uniform1(ctx, LIGHT_PICK);
    int slot = (int)(pick_u * (float)nl);
    slot = slot < nl - 1 ? slot : nl - 1;
    const int kind = lt[slot * LIGHT_I], li = lt[slot * LIGHT_I + 1];
    float u[4];
    if (kind == LIGHT_SPHERE || kind == LIGHT_PROXY) {
        f3 c;
        float r;
        light_sphere(sc, kind, li, &c, &r);
        const f3 to_c = sub3(c, o);
        const float d2 = len2(to_c);
        const float ctm = safe_sqrt(1.0f - (r * r) / cmin(d2, (float)1e-20));
        uniform4(ctx, LIGHT_SAMPLE + slot, u);
        const float phi = (u[0] * 2.0f) * (float)PI;
        const float z = 1.0f + u[1] * (ctm - 1.0f);
        const float rr = safe_sqrt(1.0f - z * z);
        const f3 local = mk3(rr * cosf(phi), rr * sinf(phi), z);
        const f3 w = normalize_eps(to_c);
        f3 bu, bv;
        onb(w, &bu, &bv);
        return onb_apply(bu, bv, w, local);
    }
    if (kind == LIGHT_PLANE) {
        const float* row = sc.f + hdr(sc, H_F_PLN) + li * PLN_F;
        uniform4(ctx, LIGHT_SAMPLE + slot, u);
        const f3 p = add3(add3(ld3(row), scale3(ld3(row + 3), u[0])), scale3(ld3(row + 6), u[1]));
        return sub3(p, o);
    }
    if (kind == LIGHT_SKY) {
        uniform4(ctx, LIGHT_SAMPLE + slot, u);
        const float z = 1.0f - 2.0f * u[0];
        const float rr = safe_sqrt(1.0f - z * z);
        const float phi = (float)(2.0 * PI) * u[1];
        return mk3(rr * cosf(phi), rr * sinf(phi), z);
    }
    return ld3(sc.f + hdr(sc, H_F_SUN) + li * SUN_F);  // LIGHT_SUN
}

__device__ __forceinline__ f3 random_unit(const Ctx& ctx, uint32_t stream) {
    float g[3];
    gaussian3(ctx, stream, g);
    return normalize_eps(mk3(g[0], g[1], g[2]));
}

__device__ __forceinline__ f3 cosine_about(f3 nrm, const Ctx& ctx, uint32_t stream) {
    float u[4];
    uniform4(ctx, stream, u);
    const float phi = (u[0] * 2.0f) * (float)PI;
    const float sqrt_r2 = safe_sqrt(u[1]);
    const f3 local = mk3(cosf(phi) * sqrt_r2, sinf(phi) * sqrt_r2, safe_sqrt(1.0f - u[1]));
    f3 bu, bv;
    onb(nrm, &bu, &bv);
    return onb_apply(bu, bv, nrm, local);
}

}  // namespace

// org, dirn (n, 3) f32.  merged == 0: t_a/i_a the sphere hit, t_b/i_b the
// plane hit, t_c/i_c the triangle walk's (t, slot); merged == 1: t_a,
// kind_in, i_a the merged hit after the volumes (sun and sky still to
// come).  pixel, sample (n,) int64; bounce (n,) int64 with bounce_stride 1,
// or one int64 (stride 0), or NULL and bounce_val; seed one int64 or NULL
// and seed_val.  Out: emission, weight, new_dir, pos (n, 3) f32, ended (n,)
// bool.  vol_count (VOL_SLOTS int64), if not NULL (merged == 1 only),
// gains the lanes whose merged hit is a volume's scattering event, and
// sph_count (VOL_SLOTS int64), if not NULL, the lanes whose closest hit is
// a sphere, of those alive (n,) bool marks (all lanes if alive is NULL):
// one atomic a warp each, into its block's slot.
//
// Seven blocks an SM: with the closures' pointers the kernel took 93
// registers (71 before), five blocks an SM; bounded to 72 (48 bytes more
// in local memory) it ran 2-5% faster on cornell_dragon's, cornell_smoke's
// and golden_monkey's mid step (PERF.md §6).
__global__ void __launch_bounds__(THREADS, 7)
vertex_shade_kernel(const float* __restrict__ ftab, const int* __restrict__ itab,
                    const float* __restrict__ tri_attr, const float* __restrict__ org,
                    const float* __restrict__ dirn, const float* __restrict__ t_a,
                    const int* __restrict__ i_a, const float* __restrict__ t_b,
                    const int* __restrict__ i_b, const float* __restrict__ t_c,
                    const int* __restrict__ i_c, const int* __restrict__ kind_in,
                    const long long* __restrict__ pixel, const long long* __restrict__ sample,
                    const long long* __restrict__ bounce, const long long* __restrict__ seed,
                    const unsigned char* __restrict__ alive,
                    unsigned long long* __restrict__ vol_count,
                    unsigned long long* __restrict__ sph_count,
                    float* __restrict__ emission_out, float* __restrict__ weight_out,
                    float* __restrict__ dir_out, unsigned char* __restrict__ ended_out,
                    float* __restrict__ pos_out, int n, int merged, int bounce_stride,
                    long long bounce_val, long long seed_val, float light_bias,
                    float one_minus_bias) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Scene sc{ftab, itab, tri_attr};
    const f3 o = ld3(org + 3 * i), d = ld3(dirn + 3 * i);
    const int ns = hdr(sc, H_NS), np = hdr(sc, H_NP), nt = hdr(sc, H_NT);
    const int nvol = hdr(sc, H_NVOL), nsky = hdr(sc, H_NSKY), nsun = hdr(sc, H_NSUN);

    // ---- the merge, sun and sky (ops/intersect.py:_intersect) ----
    float t;
    int kind, prim;
    if (merged) {
        t = t_a[i];
        kind = kind_in[i];
        prim = i_a[i];
        if (vol_count)
            warp_count(vol_count, kind == PRIM_VOLUME && (alive == nullptr || alive[i]));
    } else {
        const float ts = t_a[i], tp = t_b[i];
        const float tt = i_c[i] >= 0 ? t_c[i] : f_inf();
        t = tminimum(tminimum(ts, tp), tt);
        const bool is_s = ts <= t, is_p = tp <= t;
        kind = is_s ? PRIM_SPHERE : (is_p ? PRIM_PLANE : PRIM_TRIANGLE);
        prim = is_s ? i_a[i] : (is_p ? i_b[i] : i_c[i]);
        if (!isfinite(t)) {
            kind = PRIM_NONE;
            prim = -1;
        }
    }
    if (nsun) {
        const f3 ud = normalize3(d);
        bool miss = !isfinite(t);
        const float* sun = sc.f + hdr(sc, H_F_SUN);
        for (int ui = 0; ui < nsun; ++ui) {
            const float cs = dot3(ud, ld3(sun + ui * SUN_F));
            const bool take = miss && fabsf(cs - 1.0f) <= (float)1e-3;
            if (take) {
                t = (float)3.0e38;
                kind = PRIM_SUN;
                prim = ui;
                miss = false;
            }
        }
    }
    if (nsky && !isfinite(t)) {
        kind = PRIM_SKY;
        prim = nsky - 1;
        t = f_inf();
    }
    if (sph_count) warp_count(sph_count, kind == PRIM_SPHERE && (alive == nullptr || alive[i]));

    // ---- the hit record (ops/intersect.py:hit_attributes) ----
    const int prim0 = prim > 0 ? prim : 0;
    const bool env = kind == PRIM_SKY || kind == PRIM_SUN;
    float t_eval = (env || !isfinite(t)) ? 1.0f : t;
    const bool affine = hdr(sc, H_AFFINE) != 0;
    const float* srow = ns ? sc.f + hdr(sc, H_F_SPH) + (prim0 < ns - 1 ? prim0 : ns - 1) * SPH_F
                           : nullptr;
    const int pk = np ? (prim0 < np - 1 ? prim0 : np - 1) : 0;
    const float* prow = np ? sc.f + hdr(sc, H_F_PLN) + pk * PLN_F : nullptr;
    const float* trow =
        nt ? sc.tri + (long long)(prim0 < nt - 1 ? prim0 : nt - 1) * TRI_ATTR : nullptr;
    if (kind == PRIM_SPHERE) {
        const f3 c = ld3(srow);
        float a, half_b, cc;
        if (affine) {
            const f3 oc = matvec_bmm(srow + 4, sub3(o, c));
            const f3 dl = matvec_bmm(srow + 4, d);
            a = len2(dl);
            half_b = dot3(dl, oc);
            cc = len2(oc) - 1.0f;
        } else {
            const f3 oc = sub3(o, c);
            a = len2(d);
            half_b = dot3(d, oc);
            cc = len2(oc) - srow[3] * srow[3];
        }
        const float sq = safe_sqrt(half_b * half_b - a * cc);
        const float r1 = (-half_b - sq) / a;
        const float r2 = (-half_b + sq) / a;
        t_eval = fabsf(r1 - t_eval) <= fabsf(r2 - t_eval) ? r1 : r2;
    } else if (kind == PRIM_PLANE) {
        const f3 nrm = ld3(prow + 15);
        const float denom = dot3(nrm, d);
        t_eval = dot3(nrm, sub3(ld3(prow), o)) / (denom == 0.0f ? 1.0f : denom);
    } else if (kind == PRIM_TRIANGLE) {
        const f3 e1 = ld3(trow + 3), e2 = ld3(trow + 6);
        const f3 bq = cross3(sub3(o, ld3(trow)), e1);
        const float det = dot3(e1, cross3(d, e2));
        t_eval = dot3(e2, bq) / (det == 0.0f ? 1.0f : det);
    }
    const f3 pos = add3(o, scale3(d, t_eval));
    const f3 ud = normalize3(d);

    f3 normal = mk3(0.0f, 0.0f, 0.0f), tangent = mk3(1.0f, 0.0f, 0.0f);
    f3 bitangent = tangent;
    float2 uv = make_float2(0.0f, 0.0f);
    int mat = 0;
    if (kind == PRIM_SPHERE) {
        const f3 c = ld3(srow);
        f3 s_n, w_n;
        if (affine) {
            s_n = matvec_bmm(srow + 4, sub3(pos, c));
            w_n = normalize_eps(matvec_bmm(srow + 13, s_n));
        } else {
            s_n = div3(sub3(pos, c), srow[3]);
            w_n = s_n;
        }
        const float theta =
            acosf(clamp2(s_n.y, (float)(-1.0 + 1e-7), (float)(1.0 - 1e-7)));
        const bool pole = (fabsf(s_n.x) + fabsf(s_n.z)) < (float)1e-12;
        const float phi = atan2f(-s_n.z, pole ? 1.0f : s_n.x) + (float)PI;
        uv = make_float2(sdiv(phi, (float)(2.0 * PI)), sdiv(theta, (float)PI));
        const f3 s_tan = mk3(-s_n.z, 0.0f, -s_n.x);
        normal = w_n;
        tangent = s_tan;
        bitangent = cross3(s_n, s_tan);
        mat = sc.i[hdr(sc, H_I_SPH) + (prim0 < ns - 1 ? prim0 : ns - 1) * SPH_I];
    } else if (kind == PRIM_PLANE) {
        const f3 local = sub3(pos, ld3(prow));
        uv = make_float2(dot3(local, ld3(prow + 9)), dot3(local, ld3(prow + 12)));
        normal = ld3(prow + 15);
        tangent = normalize_eps(ld3(prow + 3));
        bitangent = normalize_eps(ld3(prow + 6));
        mat = sc.i[hdr(sc, H_I_PLN) + pk * PLN_I + 1];
    } else if (kind == PRIM_TRIANGLE) {
        const f3 v0 = ld3(trow), e1 = ld3(trow + 3), e2 = ld3(trow + 6);
        const f3 pvec = cross3(d, e2);
        const float det = dot3(e1, pvec);
        const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
        const f3 bvec = sub3(o, v0);
        const float bu = dot3(bvec, pvec) * inv_det;
        const f3 qvec = cross3(bvec, e1);
        const float bv = dot3(d, qvec) * inv_det;
        const float bw = (1.0f - bu) - bv;
        const f3 t_n = add3(add3(scale3(ld3(trow + 9), bw), scale3(ld3(trow + 12), bu)),
                            scale3(ld3(trow + 15), bv));
        const float2 uv0 = make_float2(trow[18], trow[19]);
        const float2 uv1 = make_float2(trow[20], trow[21]);
        const float2 uv2 = make_float2(trow[22], trow[23]);
        const float2 t_uv = make_float2((uv0.x * bw + uv1.x * bu) + uv2.x * bv,
                                        (uv0.y * bw + uv1.y * bu) + uv2.y * bv);
        const float2 duv1 = make_float2(uv1.x - uv0.x, uv1.y - uv0.y);
        const float2 duv2 = make_float2(uv2.x - uv0.x, uv2.y - uv0.y);
        const f3 e1perp = cross3(t_n, e1);
        const f3 e2perp = cross3(e2, t_n);
        const f3 tan = add3(scale3(e2perp, duv1.x), scale3(e1perp, duv2.x));
        const f3 bit = add3(scale3(e2perp, duv1.y), scale3(e1perp, duv2.y));
        const float inv_max = 1.0f / safe_sqrt(tmaximum(len2(tan), len2(bit)));
        const bool has_uv = trow[24] > 0.5f;
        normal = t_n;
        tangent = has_uv ? scale3(tan, -inv_max) : tangent;
        bitangent = has_uv ? scale3(bit, inv_max) : mk3(1.0f, 0.0f, 0.0f);
        uv = has_uv ? t_uv : make_float2(0.0f, 0.0f);
        mat = (int)trow[26];
    } else if (kind == PRIM_VOLUME) {
        normal = mk3(1.0f, 0.0f, 0.0f);
        mat = sc.i[hdr(sc, H_I_VOL) + (prim0 < nvol - 1 ? prim0 : nvol - 1)];
    } else if (kind == PRIM_SKY) {
        const bool kpole = (fabsf(ud.x) + fabsf(ud.z)) < (float)1e-12;
        const float k_u = sdiv(atan2f(ud.x, kpole ? 1.0f : ud.z), (float)(2.0 * PI)) + 0.5f;
        const float k_v = sdiv(ud.y, 2.0f) + 0.5f;
        normal = neg3(ud);
        uv = make_float2(k_u, k_v);
    } else if (kind == PRIM_SUN) {
        normal = neg3(ud);
    }
    const bool front_face = dot3(d, normal) < 0.0f;
    normal = front_face ? normal : neg3(normal);
    const bool valid = kind != PRIM_NONE;
    if (!valid) normal = mk3(0.0f, 0.0f, 1.0f);  // integrator.shade_hits

    // ---- the texture program (ops/texture.py:eval_program), only the
    // closure of the lane's shading key: its material, or on the sky or
    // the sun that entry (whose closure holds material 0's roots too) ----
    const int nmat = hdr(sc, H_NMAT);
    int key = mat;
    if (nsky && kind == PRIM_SKY) key = nmat + (prim0 < nsky - 1 ? prim0 : nsky - 1);
    if (nsun && kind == PRIM_SUN) key = nmat + nsky + (prim0 < nsun - 1 ? prim0 : nsun - 1);
    const int* clos = sc.i + hdr(sc, H_I_CLOS) + key * CLOS_I;
    f3 val[MAX_NODES];
    eval_closure(sc, clos, uv, pos, val);

    // ---- shading (ops/shade.py:shade) ----
    const Ctx ctx{(uint32_t)pixel[i], (uint32_t)sample[i],
                  (uint32_t)(bounce ? bounce[(long long)i * bounce_stride] : bounce_val),
                  (uint32_t)(seed ? seed[0] : seed_val)};
    const f3 unit_dir = normalize_eps(d);
    const float* mf = sc.f + hdr(sc, H_F_MAT) + mat * MAT_F;
    const int* mi = sc.i + hdr(sc, H_I_MAT) + mat * MAT_I;
    const int mtype = mi[0];
    const f3 albedo = val[clos[2]];
    const float rough = val[clos[3]].x;
    const float inv_ior = mf[0], ior = mf[1];

    f3 nrm_mapped = normal;
    if (clos[4] >= 0) {
        const f3 nm = val[clos[4]];
        const f3 dd = mk3(nm.x - 0.5f, nm.y - 0.5f, nm.z - 0.5f);
        nrm_mapped = normalize_eps(
            add3(add3(scale3(tangent, dd.x), scale3(bitangent, dd.y)), scale3(normal, dd.z)));
    }

    const bool is_emissive = mtype == MAT_EMISSIVE && valid && !env;
    f3 emission = (is_emissive && front_face) ? albedo : mk3(0.0f, 0.0f, 0.0f);
    const bool is_debug = mtype == MAT_NORMAL_DEBUG && valid && !env;
    if (is_debug) emission = add3(scale3(nrm_mapped, 0.5f), mk3(0.5f, 0.5f, 0.5f));
    if ((nsky && kind == PRIM_SKY) || (nsun && kind == PRIM_SUN)) emission = val[clos[5]];

    const bool is_metal = mtype == MAT_METAL, is_dielectric = mtype == MAT_DIELECTRIC;
    const bool is_glossy = mtype == MAT_GLOSSY, is_lambert = mtype == MAT_LAMBERTIAN;
    const bool is_iso = mtype == MAT_ISOTROPIC;

    const float u_fresnel = uniform1(ctx, FRESNEL);
    bool glossy_spec = false;
    if (is_glossy) {
        const float g_cos = cmax(dot3(neg3(unit_dir), nrm_mapped), 1.0f);
        glossy_spec = reflectance(g_cos, inv_ior) > u_fresnel;
    }
    const bool spec_lane = is_metal || glossy_spec;
    const bool pdf_family = is_lambert || is_iso || (is_glossy && !glossy_spec);

    f3 new_dir = mk3(0.0f, 0.0f, 0.0f), weight = mk3(0.0f, 0.0f, 0.0f);
    bool absorbed = false;
    if (pdf_family) {
        const f3 cos_n = is_lambert ? normal : nrm_mapped;
        const f3 mat_dir = is_iso ? random_unit(ctx, MAT_SAMPLE)
                                  : cosine_about(cos_n, ctx, MAT_SAMPLE);
        const int nl = hdr(sc, H_NLIGHT);
        const f3 light_dir = lights_sample(sc, pos, ctx);
        const float u_mix = uniform1(ctx, MIX_CHOICE);
        const bool use_light = u_mix < light_bias && nl > 0;
        const f3 nee_dir = use_light ? light_dir : mat_dir;
        const f3 unit_nee = normalize_eps(nee_dir);
        const float iso_pdf = (float)(1.0 / (4.0 * PI));
        const float cos_pdf = sdiv(cmin(dot3(unit_nee, cos_n), 0.0f), (float)PI);
        const float mat_pdf_val = is_iso ? iso_pdf : cos_pdf;
        float pdf_val = mat_pdf_val;
        if (nl > 0)
            pdf_val = mat_pdf_val * one_minus_bias + lights_pdf_value(sc, pos, nee_dir) * light_bias;
        const float scat_pdf = is_iso ? iso_pdf : cos_pdf;
        const bool pos_pdf = pdf_val > 0.0f;
        const float safe_pdf = pos_pdf ? pdf_val : 1.0f;
        weight = pos_pdf ? scale3(albedo, scat_pdf / safe_pdf) : mk3(0.0f, 0.0f, 0.0f);
        new_dir = nee_dir;
    } else if (spec_lane) {
        const f3 spec_n = is_metal ? normal : nrm_mapped;
        const f3 reflected = reflect3(d, spec_n);
        const f3 fuzz = random_unit(ctx, SPECULAR);
        const float refl_len = safe_sqrt(len2(reflected));
        const f3 fuzzy_dir = add3(reflected, scale3(fuzz, rough * refl_len));
        const bool fuzz_ok = dot3(fuzzy_dir, spec_n) > 0.0f;
        new_dir = fuzzy_dir;
        if (fuzz_ok) weight = is_metal ? albedo : mk3(1.0f, 1.0f, 1.0f);
        absorbed = !fuzz_ok;
    } else if (is_dielectric) {
        const float di_ratio = front_face ? 1.0f / ior : ior;
        const float di_cos = cmax(dot3(neg3(unit_dir), normal), 1.0f);
        const float di_sin = safe_sqrt(1.0f - di_cos * di_cos);
        const bool tir = di_ratio * di_sin > 1.0f;
        const bool di_reflect = tir || reflectance(di_cos, di_ratio) > u_fresnel;
        new_dir = di_reflect ? reflect3(unit_dir, normal) : refract3(unit_dir, normal, di_ratio);
        weight = mk3(1.0f, 1.0f, 1.0f);
    }
    const bool terminate = !valid || is_emissive || is_debug || kind == PRIM_SKY
                           || kind == PRIM_SUN || absorbed;
    if (terminate) weight = mk3(0.0f, 0.0f, 0.0f);
    if (!valid) emission = ld3(sc.f + hdr(sc, H_F_BG));

    st3(emission_out + 3 * i, emission);
    st3(weight_out + 3 * i, weight);
    st3(dir_out + 3 * i, new_dir);
    st3(pos_out + 3 * i, pos);
    ended_out[i] = terminate ? 1 : 0;
}

extern "C" int rrt_vertex_shade(const void* ftab, const void* itab, const void* tri_attr,
                                const void* org, const void* dirn, const void* t_a,
                                const void* i_a, const void* t_b, const void* i_b,
                                const void* t_c, const void* i_c, const void* kind_in,
                                const void* pixel, const void* sample, const void* bounce,
                                const void* seed, const void* alive, void* vol_count,
                                void* sph_count, void* emission, void* weight, void* new_dir,
                                void* ended, void* pos, long long n, long long merged,
                                long long bounce_stride, long long bounce_val,
                                long long seed_val, float light_bias, float one_minus_bias,
                                cudaStream_t stream) {
    const int blocks = (int)((n + THREADS - 1) / THREADS);
    vertex_shade_kernel<<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(ftab), static_cast<const int*>(itab),
        static_cast<const float*>(tri_attr), static_cast<const float*>(org),
        static_cast<const float*>(dirn), static_cast<const float*>(t_a),
        static_cast<const int*>(i_a), static_cast<const float*>(t_b),
        static_cast<const int*>(i_b), static_cast<const float*>(t_c),
        static_cast<const int*>(i_c), static_cast<const int*>(kind_in),
        static_cast<const long long*>(pixel), static_cast<const long long*>(sample),
        static_cast<const long long*>(bounce), static_cast<const long long*>(seed),
        static_cast<const unsigned char*>(alive), static_cast<unsigned long long*>(vol_count),
        static_cast<unsigned long long*>(sph_count),
        static_cast<float*>(emission), static_cast<float*>(weight), static_cast<float*>(new_dir),
        static_cast<unsigned char*>(ended), static_cast<float*>(pos), (int)n, (int)merged,
        (int)bounce_stride, bounce_val, seed_val, light_bias, one_minus_bias);
    return (int)cudaGetLastError();
}

extern "C" int rrt_vertex_shade_attrs(int* out) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, vertex_shade_kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    return 0;
}
