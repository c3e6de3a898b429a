// Kernel A of the two-level wavefront traversal: supernode block cull.
//
// Replaces the Pallas TPU kernel
// rust_raytracer_tpu/ops/pallas_wavefront.py:_make_cull_kernel (called from
// _pipeline2).  It computes the same thing: for each (packet, supernode
// slot) with slot < n1[packet], the any-hit of the packet's 8 rays against
// the supernode's 128 cluster boxes; it writes the global ids
// (sn_start[sn] + lane) of the first KC hit lanes in lane order, and the
// full hit count.  Slots >= n1 get -1 keys and a count of 0 (the TPU
// kernel leaves those rows unwritten; every reader masks them).
//
// Design: one 128-thread block per (packet, slot), one thread per cluster
// lane.  The 8 rays and their 1/d sit in shared memory; each thread ORs the
// 8 slab tests in registers; the rank of a hit lane is the popcount of the
// ballot below it in its warp plus the hits of the warps before it.  The
// TPU's MXU rank matmul and packed rank-select (_rank_select4) have no
// counterpart: a warp ballot is the cheap cross-lane scan here.
//
// What bounds it on this card: memory latency and launch width, not FLOPs.
// Each block reads 3 KB of boxes (coalesced) and does 8 x 6 slab products a
// thread; most blocks of a bounce wavefront are past n1 and exit at once.
// Left for later work: several slots per block to share the ray loads, and
// fusing A with the compaction (L2).
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

using rrt::nan_max;
using rrt::nan_min;

// sn_slot: (n_pk, k1) i32   L1-selected supernode per slot
// n1:      (n_pk,) i32      live slots per packet
// sn_start:(S,) i32         first cluster id of each supernode
// bounds:  (S, 6, 128) f32  cluster boxes lo_xyz, hi_xyz per lane
// org, dirn: (n_pk * 8, 3) f32;  tm: (n_pk * 8,) f32 = min(t_max, 3.4e38)
// keys:    (n_pk, k1, kc) i32 out;  counts: (n_pk, k1) i32 out
__global__ void __launch_bounds__(WF_SN)
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
    const int p = blockIdx.x / k1;
    const int s = blockIdx.x - p * k1;
    const int lane = threadIdx.x;
    int* key_row = keys + (size_t)blockIdx.x * kc;

    if (s >= n1[p]) {
        if (lane < kc) key_row[lane] = -1;
        if (lane == 0) counts[blockIdx.x] = 0;
        return;
    }

    __shared__ float ray[WF_R][7];  // ox oy oz inv_x inv_y inv_z tm
    __shared__ int warp_hits[WF_SN / 32];
    if (lane < WF_R) {
        const size_t i = (size_t)p * WF_R + lane;
        ray[lane][0] = org[3 * i];
        ray[lane][1] = org[3 * i + 1];
        ray[lane][2] = org[3 * i + 2];
        ray[lane][3] = 1.0f / dirn[3 * i];
        ray[lane][4] = 1.0f / dirn[3 * i + 1];
        ray[lane][5] = 1.0f / dirn[3 * i + 2];
        ray[lane][6] = tm[i];
    }
    const int sn = sn_slot[blockIdx.x];
    const float* blk = bounds + (size_t)sn * 6 * WF_SN;
    const float lo_x = blk[0 * WF_SN + lane], lo_y = blk[1 * WF_SN + lane];
    const float lo_z = blk[2 * WF_SN + lane], hi_x = blk[3 * WF_SN + lane];
    const float hi_y = blk[4 * WF_SN + lane], hi_z = blk[5 * WF_SN + lane];
    __syncthreads();

    bool hit = false;
#pragma unroll
    for (int r = 0; r < WF_R; ++r) {
        const float tx0 = (lo_x - ray[r][0]) * ray[r][3];
        const float tx1 = (hi_x - ray[r][0]) * ray[r][3];
        const float ty0 = (lo_y - ray[r][1]) * ray[r][4];
        const float ty1 = (hi_y - ray[r][1]) * ray[r][4];
        const float tz0 = (lo_z - ray[r][2]) * ray[r][5];
        const float tz1 = (hi_z - ray[r][2]) * ray[r][5];
        const float near = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                                   nan_max(nan_min(tz0, tz1), T_MIN_STATIC));
        const float far = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                                  nan_min(nan_max(tz0, tz1), ray[r][6]));
        hit |= near <= far;
    }

    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    const int warp = lane >> 5;
    const int wl = lane & 31;
    if (wl == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WF_SN / 32; ++w) {
        before += w < warp ? warp_hits[w] : 0;
        total += warp_hits[w];
    }
    const int rank = before + __popc(ballot & ((1u << wl) - 1u));
    if (hit && rank < kc) key_row[rank] = sn_start[sn] + lane;
    if (lane >= total && lane < kc) key_row[lane] = -1;
    if (lane == 0) counts[blockIdx.x] = total;
}

extern "C" int rrt_wf_cull(const int* sn_slot, const int* n1, const int* sn_start,
                           const float* bounds, const float* org,
                           const float* dirn, const float* tm, int* keys,
                           int* counts, int n_pk, int k1, int kc,
                           cudaStream_t stream) {
    if (n_pk <= 0 || k1 <= 0) return 0;
    wf_cull_kernel<<<n_pk * k1, WF_SN, 0, stream>>>(
        sn_slot, n1, sn_start, bounds, org, dirn, tm, keys, counts, k1, kc);
    return (int)cudaGetLastError();
}
