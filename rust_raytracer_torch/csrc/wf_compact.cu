// Kernel L2 of the two-level wavefront traversal: candidate compaction.
//
// Replaces the Pallas TPU kernel
// rust_raytracer_tpu/ops/pallas_wavefront.py:_make_compact_kernel (called
// from _compact_candidates).  It computes the same thing: for each packet,
// the first min(counts[s], kc) keys of each live slot s < n1, concatenated
// in slot order into one prefix-dense row of k cluster ids (-1 past the
// end), and the total over live slots of min(counts[s], kc), NOT clamped to
// k (the caller counts a packet whose total exceeds k as overflowed).
//
// Design: one warp per packet.  An exclusive warp scan of the clamped slot
// counts (32 slots per pass, a carry across passes) gives each slot's
// offset in the row; then the warp copies each slot's prefix to its offset
// and fills the tail with -1.  The TPU kernel's static-selector matmul and
// radix-4 routing network (_route_radix4) exist only because the TPU has no
// cheap cross-lane scan; a shuffle scan and direct writes replace both.
//
// What bounds it on this card: bytes.  It reads the (k1, kc) key block of
// a packet (5 KB at k1 = 40, kc = 32; only the live prefixes are touched)
// and writes one 512-byte row; there is no arithmetic to speak of.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 4
#define FULL 0xffffffffu

// keys:   (n_pk, k1, kc) i32  block-prefix-dense candidate keys
// counts: (n_pk, k1) i32      per-slot hit counts (unclamped)
// n1:     (n_pk,) i32         live slots per packet
// out:    (n_pk, k) i32 out;  total: (n_pk,) i32 out
__global__ void __launch_bounds__(32 * WARPS)
wf_compact_kernel(const int* __restrict__ keys,
                  const int* __restrict__ counts,
                  const int* __restrict__ n1,
                  int* __restrict__ out,
                  int* __restrict__ total,
                  int n_pk, int k1, int kc, int k) {
    const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (p >= n_pk) return;
    const int live = n1[p];
    const int* key_blk = keys + (size_t)p * k1 * kc;
    int* row = out + (size_t)p * k;

    int carry = 0;
    for (int base = 0; base < k1; base += 32) {
        const int s = base + lane;
        const int c = (s < k1 && s < live) ? min(counts[(size_t)p * k1 + s], kc) : 0;
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += y;
        }
        const int excl = carry + incl - c;
        const int n_slots = min(32, k1 - base);
        for (int j = 0; j < n_slots; ++j) {
            const int cj = __shfl_sync(FULL, c, j);
            const int oj = __shfl_sync(FULL, excl, j);
            const int* src = key_blk + (size_t)(base + j) * kc;
            for (int q = lane; q < cj && oj + q < k; q += 32) row[oj + q] = src[q];
        }
        carry += __shfl_sync(FULL, incl, 31);
    }
    for (int d = min(carry, k) + lane; d < k; d += 32) row[d] = -1;
    if (lane == 0) total[p] = carry;
}

extern "C" int rrt_wf_compact(const int* keys, const int* counts, const int* n1,
                              int* out, int* total, int n_pk, int k1, int kc,
                              int k, cudaStream_t stream) {
    if (n_pk <= 0) return 0;
    const int blocks = (n_pk + WARPS - 1) / WARPS;
    wf_compact_kernel<<<blocks, 32 * WARPS, 0, stream>>>(
        keys, counts, n1, out, total, n_pk, k1, kc, k);
    return (int)cudaGetLastError();
}
