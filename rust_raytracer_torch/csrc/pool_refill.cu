// KV4 of the path vertex: after the compaction sort, the permutation
// gather of every lane field, the radiance to retire, and the refill of
// dead lanes with new jobs and their camera rays, on the card.
//
// Replaces, in the port: render/pool.py:_local_step from the sort to the
// end (the gathers by the sort's permutation, the masked radiance of
// retired lanes, the refill's job ids, pixel and sample, the lane fields'
// selects, next_flat) and render/camera.py:Camera.generate_rays (the
// stratified jitter and the aperture's rim draw); in the reference these
// are XLA's fusions of the jitted step (rust_raytracer_tpu/render/pool.py
// step_local; render/camera.py:92), not a Pallas kernel.  The plain
// version is that torch-ops code.  The sort and the index_add of the
// retired radiance into the image stay PyTorch calls around this kernel.
//
// Design: one thread a sorted lane, 256 a block.  A lane gathers its
// source lane's fields (perm[i]) once and writes the next state once, the
// retired radiance (or 0) and its pixel for index_add.  The compaction key
// puts every dead lane after every live one (the dead flag is the key's
// bit 31), so the plain version's cumsum of dead lanes is, at sorted
// position i of a dead lane, i - (n - n_dead): n_dead is the count that
// lane_update_kernel made (a 0-d int64 on the card), and no scan runs.
// Thread 0 also writes next_flat = min(next_flat + n_dead, quota) and the
// overflow sum.  The camera's constants come from ops/vertex.py's camera
// table, its pcg4d draws from pcg4d.cuh; arithmetic is the plain
// version's operation for operation.
//
// What bounds it: bytes.  Every lane reads 30 (perm, radiance, pixel,
// still, retired) and writes 93 (the next state, the pixel and radiance
// for index_add); a lane that keeps its path (not refilled) also reads
// its org, dirn, throughput, sample and bounce, 52 more.  The gathers are
// random reads of 1-12 bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pcg4d.cuh"
#include "vertex_common.cuh"

using namespace rrt;

#define THREADS 256

// camera table (ops/vertex.py:camera_table): position, first_pixel,
// pixel_delta_u, pixel_delta_v, basis u, basis v (3 each), aperture radius,
// 1 / sqrt_spt
enum Cam { C_POS = 0, C_FIRST = 3, C_DU = 6, C_DV = 9, C_BU = 12, C_BV = 15, C_APERTURE = 18,
           C_INV_SQRT_SPT = 19 };

__global__ void __launch_bounds__(THREADS)
pool_refill_kernel(const long long* __restrict__ perm, const float* __restrict__ org,
                   const float* __restrict__ dirn, const float* __restrict__ thr,
                   const float* __restrict__ rad, const long long* __restrict__ pixel,
                   const long long* __restrict__ sample, const long long* __restrict__ bounce,
                   const unsigned char* __restrict__ still,
                   const unsigned char* __restrict__ retired,
                   const unsigned long long* __restrict__ n_dead_p,
                   const long long* __restrict__ next_flat, const long long* __restrict__ ov_in,
                   const long long* __restrict__ ov_add, const float* __restrict__ cam,
                   float* __restrict__ org_out, float* __restrict__ dirn_out,
                   float* __restrict__ thr_out, float* __restrict__ rad_out,
                   long long* __restrict__ pixel_out, long long* __restrict__ sample_out,
                   long long* __restrict__ bounce_out, unsigned char* __restrict__ active_out,
                   long long* __restrict__ ret_pixel, float* __restrict__ contrib,
                   long long* __restrict__ next_flat_out, long long* __restrict__ ov_out, int n,
                   long long quota, long long job_base, long long spp, long long width,
                   long long sqrt_spt, int has_aperture, long long seed) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const long long n_dead = (long long)n_dead_p[0];
    const long long nf = next_flat[0];
    if (i == 0) {
        const long long v = nf + n_dead;
        next_flat_out[0] = v < quota ? v : quota;
        ov_out[0] = ov_in[0] + (ov_add ? ov_add[0] : 0);
    }
    if (i >= n) return;
    const long long j = perm[i];
    const f3 r = ld3(rad + 3 * j);
    const bool ret = retired[j] != 0, st = still[j] != 0;
    const long long pix = pixel[j];
    ret_pixel[i] = pix;
    st3(contrib + 3 * i, ret ? r : mk3(0.0f, 0.0f, 0.0f));

    const long long new_local = nf + ((long long)i - ((long long)n - n_dead));
    const bool issue = !st && new_local < quota;
    if (!issue) {
        st3(org_out + 3 * i, ld3(org + 3 * j));
        st3(dirn_out + 3 * i, ld3(dirn + 3 * j));
        st3(thr_out + 3 * i, ld3(thr + 3 * j));
        st3(rad_out + 3 * i, ret ? mk3(0.0f, 0.0f, 0.0f) : r);
        pixel_out[i] = pix;
        sample_out[i] = sample[j];
        bounce_out[i] = bounce[j];
        active_out[i] = st ? 1 : 0;
        return;
    }
    // ---- a new job: render/camera.py:generate_rays ----
    const long long flat = new_local + job_base;
    const long long p = flat / spp, smp = flat % spp;
    const long long px = p % width, py = p / width;
    const Ctx ctx{(uint32_t)p, (uint32_t)smp, 0u, (uint32_t)seed};
    const long long jj = smp % (sqrt_spt * sqrt_spt);
    const float sx = (float)(jj % sqrt_spt), sy = (float)(jj / sqrt_spt);
    float u[4];
    uniform4(ctx, PIXEL_JITTER, u);
    const float inv = cam[C_INV_SQRT_SPT];
    const float ox = (sx + u[0]) * inv - 0.5f;
    const float oy = (sy + u[1]) * inv - 0.5f;
    const f3 ps = add3(add3(ld3(cam + C_FIRST), scale3(ld3(cam + C_DU), (float)px + ox)),
                       scale3(ld3(cam + C_DV), (float)py + oy));
    f3 o = ld3(cam + C_POS);
    if (has_aperture) {
        float c[4];
        uniform4(ctx, APERTURE, c);
        const float phi = (float)(2.0 * PI) * c[0];
        const f3 rim = add3(scale3(ld3(cam + C_BU), cosf(phi)), scale3(ld3(cam + C_BV), sinf(phi)));
        o = add3(o, scale3(rim, cam[C_APERTURE]));
    }
    st3(org_out + 3 * i, o);
    st3(dirn_out + 3 * i, sub3(ps, o));
    st3(thr_out + 3 * i, mk3(1.0f, 1.0f, 1.0f));
    st3(rad_out + 3 * i, mk3(0.0f, 0.0f, 0.0f));
    pixel_out[i] = p;
    sample_out[i] = smp;
    bounce_out[i] = 0;
    active_out[i] = 1;
}

// perm: the stable sort's permutation (n,) int64; the lane fields as
// lane_update_kernel wrote them (unsorted); n_dead: its count of dead lanes;
// next_flat, ov_in, ov_add (or NULL): 0-d int64; cam: the camera table.
// Out: the next lane fields, ret_pixel (n,) int64 and contrib (n, 3) for
// the index_add, next_flat_out and ov_out (0-d int64).
extern "C" int rrt_pool_refill(const void* perm, const void* org, const void* dirn,
                               const void* thr, const void* rad, const void* pixel,
                               const void* sample, const void* bounce, const void* still,
                               const void* retired, const void* n_dead, const void* next_flat,
                               const void* ov_in, const void* ov_add, const void* cam,
                               void* org_out, void* dirn_out, void* thr_out, void* rad_out,
                               void* pixel_out, void* sample_out, void* bounce_out,
                               void* active_out, void* ret_pixel, void* contrib,
                               void* next_flat_out, void* ov_out, long long n, long long quota,
                               long long job_base, long long spp, long long width,
                               long long sqrt_spt, long long has_aperture, long long seed,
                               cudaStream_t stream) {
    const int blocks = (int)((n + THREADS - 1) / THREADS);
    pool_refill_kernel<<<blocks > 0 ? blocks : 1, THREADS, 0, stream>>>(
        static_cast<const long long*>(perm), static_cast<const float*>(org),
        static_cast<const float*>(dirn), static_cast<const float*>(thr),
        static_cast<const float*>(rad), static_cast<const long long*>(pixel),
        static_cast<const long long*>(sample), static_cast<const long long*>(bounce),
        static_cast<const unsigned char*>(still), static_cast<const unsigned char*>(retired),
        static_cast<const unsigned long long*>(n_dead), static_cast<const long long*>(next_flat),
        static_cast<const long long*>(ov_in), static_cast<const long long*>(ov_add),
        static_cast<const float*>(cam), static_cast<float*>(org_out),
        static_cast<float*>(dirn_out), static_cast<float*>(thr_out),
        static_cast<float*>(rad_out), static_cast<long long*>(pixel_out),
        static_cast<long long*>(sample_out), static_cast<long long*>(bounce_out),
        static_cast<unsigned char*>(active_out), static_cast<long long*>(ret_pixel),
        static_cast<float*>(contrib), static_cast<long long*>(next_flat_out),
        static_cast<long long*>(ov_out), (int)n, quota, job_base, spp, width, sqrt_spt,
        (int)has_aperture, seed);
    return (int)cudaGetLastError();
}

extern "C" int rrt_pool_refill_attrs(int* out) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, pool_refill_kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    return 0;
}
