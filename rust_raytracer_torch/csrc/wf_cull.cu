// Kernel A of the two-level wavefront traversal: supernode block cull, and
// its fusion with kernel L2 (candidate compaction).
//
// Replaces the Pallas TPU kernels
// rust_raytracer_tpu/ops/pallas_wavefront.py:_make_cull_kernel (called from
// _pipeline2) and, fused, :_make_compact_kernel (called from
// _compact_candidates).  One slab walk, two outputs:
// - wf_cull_kernel computes what the cull kernel does: for each (packet,
//   supernode slot) with slot < n1[packet], the any-hit of the packet's 8
//   rays against the supernode's 128 cluster boxes; it writes the global
//   ids (sn_start[sn] + lane) of the first KC hit lanes in lane order, and
//   the full hit count.  Slots >= n1 get -1 keys and a count of 0 (the TPU
//   kernel leaves those rows unwritten; every reader masks them).
// - wf_cull_compact_kernel computes what the cull kernel then the
//   compaction kernel do: the same counts, and in place of the keys the
//   packet's candidate row, the first min(count, KC) ids of each live slot
//   concatenated in slot order into k entries (-1 past the end), with the
//   unclamped total of min(count, KC) over live slots.  The (n_pk, k1, KC)
//   key buffer (168 MB at the pool width) and the compaction launch go.
//
// Design: one 128-thread block per packet, one thread per cluster lane, as
// the TPU kernel works packet by packet.
// - The 8 rays and their 24 reciprocals are loaded once a packet (24
//   threads compute one reciprocal each), then held in every thread's
//   registers.
// - The block walks the packet's n1 live slots in slot order; the next
//   slot's 3 KB of boxes (six coalesced rows) are loaded into registers
//   while the current slot is tested.
// - Each thread ORs the 8 slab tests; the rank of a hit lane is the
//   popcount of the ballot below it in its warp plus the hits of the warps
//   before it (one barrier a slot, the warp counts double-buffered).
// - The fused walk keeps the row's fill `off`: the running sum of
//   min(count, KC), which is the offset the compaction kernel's warp scan
//   computes.  A hit lane of rank < KC writes its id to row[off + rank]
//   while that is below k, so a cap that falls inside a slot keeps the
//   slot's first lanes.  `off` lives in shared memory, double-buffered as
//   the warp counts are (lane 0 writes the next slot's after the barrier):
//   carried in a register through the walk it spilled at 8 blocks an SM.
//   The walk goes on past a full row, since the total and the counts must
//   stay exact.
// - After the walk the dead slots' rows (-1 keys, 0 counts) or the row's
//   tail (-1) are filled with coalesced stores.  No block is launched for
//   dead slots alone.
// The TPU's MXU rank matmul and packed rank-select (_rank_select4), and the
// compaction's selector matmul and radix-4 routing network, have no
// counterpart: a warp ballot is the cheap cross-lane scan here.
//
// What bounds it on this card: issuing the slab tests.  A test is 12
// float adds and multiplies, 12 min/max (which issue at half the
// add/multiply rate) and a compare: one instruction each min/max
// (min.NaN / max.NaN) keeps that at 25, ~38 with each slot's loads, ranks
// and stores spread over its 8 tests.  The cull's keys are 168 MB at the
// pool width, ~0.05 ms of bytes; the fused kernel's row is 16 MB.
//
// Arithmetic is the reference kernel's (its :344-361), operation for
// operation, with min/max that propagate NaN as jnp.minimum/maximum do.
// The unused lanes of a supernode hold +3.4e38 point boxes, which that
// arithmetic rejects for every ray whose three direction components
// differ; no lane-count mask is added, so the port culls as the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse_common.cuh"

#define WF_R 8          // rays per packet
#define WF_SN 128       // cluster lanes per supernode block
#define T_MIN_STATIC rrt::kTMin
// resident blocks an SM must be able to hold: at most 64 registers a thread
#define WF_CULL_MIN_BLOCKS 8

// min/max that return NaN where either input is NaN, one instruction each
// (PTX min.NaN / max.NaN, sm_80 and later).  They give the hit bits of
// rrt::nan_min/nan_max (a compare, a NaN test and a select each): NaN
// reaches near or far alike and fails near <= far; and the two may differ
// only in the sign of a zero result, which never decides a hit, since near
// is at least T_MIN.
__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

struct Box {
    float lo_x, lo_y, lo_z, hi_x, hi_y, hi_z;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ bounds, int sn, int lane) {
    const float* blk = bounds + (size_t)sn * 6 * WF_SN + lane;
    return Box{__ldg(blk), __ldg(blk + WF_SN), __ldg(blk + 2 * WF_SN),
               __ldg(blk + 3 * WF_SN), __ldg(blk + 4 * WF_SN), __ldg(blk + 5 * WF_SN)};
}

// The walk of one packet (blockIdx.x), shared by both kernels.
// sn_slot: (n_pk, k1) i32   L1-selected supernode per slot
// n1:      (n_pk,) i32      live slots per packet
// sn_start:(S,) i32         first cluster id of each supernode
// bounds:  (S, 6, 128) f32  cluster boxes lo_xyz, hi_xyz per lane
// org, dirn: (n_pk * 8, 3) f32;  tm: (n_pk * 8,) f32 = min(t_max, 3.4e38)
// counts:  (n_pk, k1) i32 out
// kFused false: out = keys (n_pk, k1, kc) i32; total and k unused.
// kFused true:  out = row (n_pk, k) i32; total (n_pk,) i32 out.
template <bool kFused>
__device__ __forceinline__ void cull_walk(const int* __restrict__ sn_slot,
                                          const int* __restrict__ n1,
                                          const int* __restrict__ sn_start,
                                          const float* __restrict__ bounds,
                                          const float* __restrict__ org,
                                          const float* __restrict__ dirn,
                                          const float* __restrict__ tm,
                                          int* __restrict__ out,
                                          int* __restrict__ counts,
                                          int* __restrict__ total_out,
                                          int k1, int kc, int k) {
    const int p = blockIdx.x;
    const int lane = threadIdx.x;
    const int warp = lane >> 5;
    const int wl = lane & 31;
    const int n_live = max(0, min(n1[p], k1));
    const int* slot_row = sn_slot + (size_t)p * k1;
    int* key_blk = out + (size_t)p * k1 * kc;  // kFused: unused
    int* row = out + (size_t)p * k;            // kFused only
    int* cnt_row = counts + (size_t)p * k1;
    __shared__ int off_s[2];  // kFused: the row's fill before slot s, at s & 1
    int off = 0;              // kFused: the row's fill after the walk

    if (n_live > 0) {
        __shared__ float ray_s[WF_R][7];  // ox oy oz inv_x inv_y inv_z tm
        __shared__ int warp_hits[2][WF_SN / 32];
        if (kFused && lane == 0) off_s[0] = 0;
        if (lane < 3 * WF_R) {
            const size_t i = (size_t)p * WF_R * 3 + lane;
            ray_s[lane / 3][lane % 3] = __ldg(org + i);
            ray_s[lane / 3][3 + lane % 3] = 1.0f / __ldg(dirn + i);
        } else if (lane < 4 * WF_R) {
            ray_s[lane - 3 * WF_R][6] = __ldg(tm + (size_t)p * WF_R + lane - 3 * WF_R);
        }
        int sn = slot_row[0];
        Box b = load_box(bounds, sn, lane);
        int base = __ldg(sn_start + sn);
        int sn_next = slot_row[min(1, n_live - 1)];
        __syncthreads();
        float ox[WF_R], oy[WF_R], oz[WF_R], ix[WF_R], iy[WF_R], iz[WF_R], tr[WF_R];
#pragma unroll
        for (int r = 0; r < WF_R; ++r) {
            ox[r] = ray_s[r][0];
            oy[r] = ray_s[r][1];
            oz[r] = ray_s[r][2];
            ix[r] = ray_s[r][3];
            iy[r] = ray_s[r][4];
            iz[r] = ray_s[r][5];
            tr[r] = ray_s[r][6];
        }

        for (int s = 0; s < n_live; ++s) {
            // the next slot's boxes go in flight before this one is tested
            // (the last slot reloads its own rather than branch)
            const int sn_after = slot_row[min(s + 2, n_live - 1)];
            const Box nb = load_box(bounds, sn_next, lane);
            const int nbase = __ldg(sn_start + sn_next);

            bool hit = false;
#pragma unroll
            for (int r = 0; r < WF_R; ++r) {
                const float tx0 = (b.lo_x - ox[r]) * ix[r];
                const float tx1 = (b.hi_x - ox[r]) * ix[r];
                const float ty0 = (b.lo_y - oy[r]) * iy[r];
                const float ty1 = (b.hi_y - oy[r]) * iy[r];
                const float tz0 = (b.lo_z - oz[r]) * iz[r];
                const float tz1 = (b.hi_z - oz[r]) * iz[r];
                const float near = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                                           max_nan(min_nan(tz0, tz1), T_MIN_STATIC));
                const float far = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                                          min_nan(max_nan(tz0, tz1), tr[r]));
                hit |= near <= far;
            }

            const unsigned ballot = __ballot_sync(0xffffffffu, hit);
            if (wl == 0) warp_hits[s & 1][warp] = __popc(ballot);
            __syncthreads();
            int before = 0, total = 0;
#pragma unroll
            for (int w = 0; w < WF_SN / 32; ++w) {
                const int h = warp_hits[s & 1][w];
                before += w < warp ? h : 0;
                total += h;
            }
            const int rank = before + __popc(ballot & ((1u << wl) - 1u));
            if (kFused) {
                const int off_now = off_s[s & 1];
                if (hit && rank < kc && off_now + rank < k) row[off_now + rank] = base + lane;
                if (lane == 0) off_s[(s + 1) & 1] = off_now + min(total, kc);
            } else {
                int* key_row = key_blk + (size_t)s * kc;
                if (hit && rank < kc) key_row[rank] = base + lane;
                if (lane >= total && lane < kc) key_row[lane] = -1;
            }
            if (lane == 0) cnt_row[s] = total;

            sn_next = sn_after;
            b = nb;
            base = nbase;
        }
        if (kFused) {
            __syncthreads();
            off = off_s[n_live & 1];
        }
    }

    if (kFused) {
        // the row's tail, and the unclamped total
        for (int i = min(off, k) + lane; i < k; i += WF_SN) row[i] = -1;
        if (lane == 0) total_out[p] = off;
    } else {
        // the dead slots' rows: -1 keys
        for (int i = n_live * kc + lane; i < k1 * kc; i += WF_SN) key_blk[i] = -1;
    }
    // the dead slots' counts: 0
    for (int s = n_live + lane; s < k1; s += WF_SN) cnt_row[s] = 0;
}

// keys: (n_pk, k1, kc) i32 out;  counts: (n_pk, k1) i32 out
__global__ void __launch_bounds__(WF_SN, WF_CULL_MIN_BLOCKS)
wf_cull_kernel(const int* __restrict__ sn_slot,
               const int* __restrict__ n1,
               const int* __restrict__ sn_start,
               const float* __restrict__ bounds,
               const float* __restrict__ org,
               const float* __restrict__ dirn,
               const float* __restrict__ tm,
               int* __restrict__ keys,
               int* __restrict__ counts,
               int k1, int kc) {
    cull_walk<false>(sn_slot, n1, sn_start, bounds, org, dirn, tm, keys, counts, nullptr,
                     k1, kc, 0);
}

// row: (n_pk, k) i32 out;  total: (n_pk,) i32 out;  counts: (n_pk, k1) i32 out
__global__ void __launch_bounds__(WF_SN, WF_CULL_MIN_BLOCKS)
wf_cull_compact_kernel(const int* __restrict__ sn_slot,
                       const int* __restrict__ n1,
                       const int* __restrict__ sn_start,
                       const float* __restrict__ bounds,
                       const float* __restrict__ org,
                       const float* __restrict__ dirn,
                       const float* __restrict__ tm,
                       int* __restrict__ row,
                       int* __restrict__ total,
                       int* __restrict__ counts,
                       int k1, int kc, int k) {
    cull_walk<true>(sn_slot, n1, sn_start, bounds, org, dirn, tm, row, counts, total,
                    k1, kc, k);
}

extern "C" int rrt_wf_cull(const int* sn_slot, const int* n1, const int* sn_start,
                           const float* bounds, const float* org,
                           const float* dirn, const float* tm, int* keys,
                           int* counts, int n_pk, int k1, int kc,
                           cudaStream_t stream) {
    if (n_pk <= 0 || k1 <= 0) return 0;
    wf_cull_kernel<<<n_pk, WF_SN, 0, stream>>>(
        sn_slot, n1, sn_start, bounds, org, dirn, tm, keys, counts, k1, kc);
    return (int)cudaGetLastError();
}

extern "C" int rrt_wf_cull_compact(const int* sn_slot, const int* n1, const int* sn_start,
                                   const float* bounds, const float* org,
                                   const float* dirn, const float* tm, int* row,
                                   int* total, int* counts, int n_pk, int k1, int kc,
                                   int k, cudaStream_t stream) {
    if (n_pk <= 0 || k1 <= 0 || k <= 0) return 0;
    wf_cull_compact_kernel<<<n_pk, WF_SN, 0, stream>>>(
        sn_slot, n1, sn_start, bounds, org, dirn, tm, row, total, counts, k1, kc, k);
    return (int)cudaGetLastError();
}

// A kernel's registers a thread, local bytes a thread (stack frame and
// spills) and static shared bytes, as the loaded module reports them.
static int attrs(const void* kernel, int* out) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    return 0;
}

extern "C" int rrt_wf_cull_attrs(int* out) {
    return attrs((const void*)wf_cull_kernel, out);
}

extern "C" int rrt_wf_cull_compact_attrs(int* out) {
    return attrs((const void*)wf_cull_compact_kernel, out);
}
