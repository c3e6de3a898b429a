// KV3 of the path vertex: the lane update after shading and the int64
// compaction key, on the card.
//
// Replaces, in the port: render/pool.py:_local_step's lane update (the
// radiance, throughput and bounce, the still / retired flags with the
// max_depth test, the next origin and direction), render/integrator.py:
// _advance (the batch bounce's update, the same without a depth test) and
// integrator._compaction_key; in the reference these are XLA's fusions of
// the jitted step (rust_raytracer_tpu/render/pool.py:159- step_local;
// render/integrator.py:52, :197-208), not a Pallas kernel.  The plain
// versions are that torch-ops code.
//
// Design: the key needs the bounding box of every lane's origin (torch's
// amin / amax over the lane axis), so it is two launches.
// lane_bbox_kernel (one thread a lane, 256 a block) reduces each block's
// box of the origins; the last block to finish (a counter in a zeroed
// scratch word) reduces the blocks' boxes into the final one.
// compaction_key_kernel then reads each lane's origin, direction and flag
// with that box and writes the key.  min and max are exact and propagate
// NaN here as torch's do, so the box, and every key, equal the plain
// version's bit for bit.  lane_update_kernel (one thread a lane) reads a
// lane's state and shading once and writes its new state once, its
// arithmetic the plain version's operation for operation; in the pool form
// it also counts the dead lanes (one ballot a warp, one atomic add a warp)
// for pool_refill.
//
// What bounds them: bytes.  The pool update reads 69 bytes a lane (active,
// throughput, emission, radiance, bounce, one of org / pos and one of
// dirn / new_dir) and 13 more on a live lane (weight, ended), and writes
// 58; the box reads 12 (the origin); the key reads 25 and writes 8.
#include <cuda_runtime.h>
#include <stdint.h>

#include "vertex_common.cuh"

using namespace rrt;

#define THREADS 256
#define WARPS (THREADS / 32)

namespace {

// torch.amin / amax: NaN wins
__device__ __forceinline__ float nmin(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ float nmax(float a, float b) { return (a != a || a > b) ? a : b; }

// Reduce the block's box (lo, hi of each lane) into partial[blockIdx], and
// in the last block to arrive, every block's into box[6].  counter: a
// zeroed word, left at gridDim.x.
__device__ void reduce_box(float lo[3], float hi[3], float* partial, float* box,
                           unsigned long long* counter) {
    __shared__ float s[6][WARPS];
    __shared__ bool last;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1)
        for (int k = 0; k < 3; ++k) {
            lo[k] = nmin(lo[k], __shfl_down_sync(0xffffffffu, lo[k], off));
            hi[k] = nmax(hi[k], __shfl_down_sync(0xffffffffu, hi[k], off));
        }
    if (lane == 0)
        for (int k = 0; k < 3; ++k) {
            s[k][warp] = lo[k];
            s[3 + k][warp] = hi[k];
        }
    __syncthreads();
    if (threadIdx.x < 6) {
        float v = s[threadIdx.x][0];
        for (int w = 1; w < WARPS; ++w)
            v = threadIdx.x < 3 ? nmin(v, s[threadIdx.x][w]) : nmax(v, s[threadIdx.x][w]);
        partial[blockIdx.x * 6 + threadIdx.x] = v;
        __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counter, 1ull) == (unsigned long long)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int k = 0; k < 3; ++k) {
        lo[k] = f_inf();
        hi[k] = -f_inf();
    }
    for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)
        for (int k = 0; k < 3; ++k) {
            lo[k] = nmin(lo[k], __ldcg(partial + b * 6 + k));
            hi[k] = nmax(hi[k], __ldcg(partial + b * 6 + 3 + k));
        }
    __syncthreads();
    for (int off = 16; off > 0; off >>= 1)
        for (int k = 0; k < 3; ++k) {
            lo[k] = nmin(lo[k], __shfl_down_sync(0xffffffffu, lo[k], off));
            hi[k] = nmax(hi[k], __shfl_down_sync(0xffffffffu, hi[k], off));
        }
    if (lane == 0)
        for (int k = 0; k < 3; ++k) {
            s[k][warp] = lo[k];
            s[3 + k][warp] = hi[k];
        }
    __syncthreads();
    if (threadIdx.x < 6) {
        float v = s[threadIdx.x][0];
        for (int w = 1; w < WARPS; ++w)
            v = threadIdx.x < 3 ? nmin(v, s[threadIdx.x][w]) : nmax(v, s[threadIdx.x][w]);
        box[threadIdx.x] = v;
    }
}

__device__ __forceinline__ long long expand_bits8(long long v) {
    v = (v | (v << 16)) & 0x030000FF;
    v = (v | (v << 8)) & 0x0300F00F;
    v = (v | (v << 4)) & 0x030C30C3;
    v = (v | (v << 2)) & 0x09249249;
    return v;
}

}  // namespace

// pool (bounce != NULL): state org, dirn, throughput, radiance (n, 3),
// bounce (n,) int64, active (n,) bool; shading emission, weight, new_dir,
// pos (n, 3), ended (n,) bool.  Out: org, dirn, throughput, radiance,
// bounce, still, retired, and n_dead (a zeroed uint64): the count of lanes
// not still.  batch: bounce, bounce_out, retired and n_dead are NULL,
// still is the next alive flag and no depth test applies.
__global__ void __launch_bounds__(THREADS)
lane_update_kernel(const float* __restrict__ org, const float* __restrict__ dirn,
                   const float* __restrict__ thr, const float* __restrict__ rad,
                   const long long* __restrict__ bounce, const unsigned char* __restrict__ active,
                   const float* __restrict__ emission, const float* __restrict__ weight,
                   const float* __restrict__ new_dir, const unsigned char* __restrict__ ended,
                   const float* __restrict__ pos, float* __restrict__ org_out,
                   float* __restrict__ dirn_out, float* __restrict__ thr_out,
                   float* __restrict__ rad_out, long long* __restrict__ bounce_out,
                   unsigned char* __restrict__ still_out, unsigned char* __restrict__ retired_out,
                   unsigned long long* n_dead, int n, long long max_depth) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    bool still = false;
    if (i < n) {
        const bool act = active[i] != 0;
        const float actf = act ? 1.0f : 0.0f;
        const f3 t = ld3(thr + 3 * i), e = ld3(emission + 3 * i);
        st3(rad_out + 3 * i, add3(ld3(rad + 3 * i), scale3(mul3(t, e), actf)));
        st3(thr_out + 3 * i, mul3(t, act ? ld3(weight + 3 * i) : mk3(0.0f, 0.0f, 0.0f)));
        still = act && !ended[i];
        if (bounce) {
            const long long b = bounce[i] + 1;
            bounce_out[i] = b;
            still = still && b < max_depth;
            retired_out[i] = act && !still;
        }
        st3(org_out + 3 * i, still ? ld3(pos + 3 * i) : ld3(org + 3 * i));
        st3(dirn_out + 3 * i, still ? ld3(new_dir + 3 * i) : ld3(dirn + 3 * i));
        still_out[i] = still ? 1 : 0;
    }
    if (n_dead) {
        // every thread of the warp reaches this ballot (THREADS is a
        // multiple of 32 and no thread returns above), so the full mask
        const unsigned dead = __ballot_sync(0xffffffffu, i < n && !still);
        if ((threadIdx.x & 31) == 0 && dead)
            atomicAdd(n_dead, (unsigned long long)__popc(dead));
    }
}

// The box of org (n, 3): lo, hi into box[6].  counter: a zeroed uint64
// (the block counter); partial: 6 floats a block.
__global__ void __launch_bounds__(THREADS)
lane_bbox_kernel(const float* __restrict__ org, unsigned long long* counter, float* partial,
                 float* box, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    float lo[3] = {f_inf(), f_inf(), f_inf()}, hi[3] = {-f_inf(), -f_inf(), -f_inf()};
    if (i < n)
        for (int k = 0; k < 3; ++k) lo[k] = hi[k] = org[3 * i + k];
    reduce_box(lo, hi, partial, box, counter);
}

// integrator._compaction_key with dir_bits = 3
__global__ void __launch_bounds__(THREADS)
compaction_key_kernel(const float* __restrict__ org, const float* __restrict__ dirn,
                      const unsigned char* __restrict__ alive, const float* __restrict__ box,
                      long long* __restrict__ key, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const f3 o = ld3(org + 3 * i), d = ld3(dirn + 3 * i);
    const float lo[3] = {box[0], box[1], box[2]};
    const float oo[3] = {o.x, o.y, o.z};
    long long q[3];
    for (int k = 0; k < 3; ++k) {
        const float span = cmin(box[3 + k] - lo[k], (float)1e-20);
        q[k] = (long long)clamp2((oo[k] - lo[k]) / span * 255.0f, 0.0f, 255.0f);
    }
    const long long morton =
        (expand_bits8(q[0]) << 2) | (expand_bits8(q[1]) << 1) | expand_bits8(q[2]);
    const long long dead = alive[i] ? 0 : 1;
    const long long octant = (long long)(d.x < 0.0f) * 4 + (long long)(d.y < 0.0f) * 2
                             + (long long)(d.z < 0.0f);
    long long k = (dead << 31) | (octant << 28);
    const f3 a = mk3(fabsf(d.x), fabsf(d.y), fabsf(d.z));
    const float s = cmin(a.x + a.y + a.z, (float)1e-20);
    long long qx = (long long)(a.x / s * 7.0f), qy = (long long)(a.y / s * 7.0f);
    qx = qx < 0 ? 0 : (qx > 7 ? 7 : qx);
    qy = qy < 0 ? 0 : (qy > 7 ? 7 : qy);
    k = k | (qx << 25) | (qy << 22);
    key[i] = k | (morton >> 2);
}

extern "C" int rrt_lane_update(const void* org, const void* dirn, const void* thr,
                               const void* rad, const void* bounce, const void* active,
                               const void* emission, const void* weight, const void* new_dir,
                               const void* ended, const void* pos, void* org_out,
                               void* dirn_out, void* thr_out, void* rad_out, void* bounce_out,
                               void* still_out, void* retired_out, void* n_dead, long long n,
                               long long max_depth, cudaStream_t stream) {
    const int blocks = (int)((n + THREADS - 1) / THREADS);
    lane_update_kernel<<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(org), static_cast<const float*>(dirn),
        static_cast<const float*>(thr), static_cast<const float*>(rad),
        static_cast<const long long*>(bounce), static_cast<const unsigned char*>(active),
        static_cast<const float*>(emission), static_cast<const float*>(weight),
        static_cast<const float*>(new_dir), static_cast<const unsigned char*>(ended),
        static_cast<const float*>(pos), static_cast<float*>(org_out),
        static_cast<float*>(dirn_out), static_cast<float*>(thr_out),
        static_cast<float*>(rad_out), static_cast<long long*>(bounce_out),
        static_cast<unsigned char*>(still_out), static_cast<unsigned char*>(retired_out),
        static_cast<unsigned long long*>(n_dead), (int)n, max_depth);
    return (int)cudaGetLastError();
}

extern "C" int rrt_lane_bbox(const void* org, void* counter, void* partial, void* box,
                             long long n, cudaStream_t stream) {
    const int blocks = (int)((n + THREADS - 1) / THREADS);
    lane_bbox_kernel<<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(org), static_cast<unsigned long long*>(counter),
        static_cast<float*>(partial), static_cast<float*>(box), (int)n);
    return (int)cudaGetLastError();
}

extern "C" int rrt_compaction_key(const void* org, const void* dirn, const void* alive,
                                  const void* box, void* key, long long n,
                                  cudaStream_t stream) {
    const int blocks = (int)((n + THREADS - 1) / THREADS);
    compaction_key_kernel<<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(org), static_cast<const float*>(dirn),
        static_cast<const unsigned char*>(alive), static_cast<const float*>(box),
        static_cast<long long*>(key), (int)n);
    return (int)cudaGetLastError();
}

static int attrs_of(const void* fn, int* out) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    return 0;
}

extern "C" int rrt_lane_update_attrs(int* out) {
    return attrs_of((const void*)lane_update_kernel, out);
}

extern "C" int rrt_lane_bbox_attrs(int* out) {
    return attrs_of((const void*)lane_bbox_kernel, out);
}

extern "C" int rrt_compaction_key_attrs(int* out) {
    return attrs_of((const void*)compaction_key_kernel, out);
}
