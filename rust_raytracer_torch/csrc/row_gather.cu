// The backward of a per-lane row gather, out = table[idx]: the gradient
// of the table, grad_table[r] = the sum of grad_out[i] over the lanes i
// with idx[i] == r, as a segmented sum over the ids sorted once.
//
// Replaces no TPU kernel: the reference leaves the gather's transpose to
// XLA's scatter-add (rust_raytracer_tpu/ops/intersect.py:hit_attributes,
// ops/shade.py:shade under jax.grad).  It replaces, in the port, PyTorch's
// backward of table[idx] (index_put_ with accumulate after a sort), whose
// kernel gives one warp to each distinct row and walks that row's lanes in
// series: in the differentiable trace tens of thousands of lanes gather a
// handful of rows (dead lanes and misses clamp to row 0, a lane of one
// primitive kind clamps its id into the other kinds' tables), so a few
// warps walk nearly every lane while the card idles.
//
// Design: balanced by position, not by row.  The wrapper (ops/gather.py)
// sorts the ids once (stable, torch.sort) and hands over the sorted ids
// and their lanes.  row_gather_bwd_tile gives each block TILE sorted
// positions; it stages the lanes' gradient rows CHUNK columns at a time in
// shared memory and sums each run of equal ids inside the tile with a
// segmented inclusive scan in a fixed order (warp shuffles, then the
// warps' totals in warp order).  The last position of a run holds the
// run's sum: a run wholly inside the tile is written straight to the
// gradient table by that one thread, with no atomics; a run cut by the
// tile's first or last position goes to the tile's carry (slot 0 the first
// run, slot 1 the last; at most 2 a tile, the run's id in carry_id, -1
// where unused).  row_gather_bwd_carry then gives each cut run one
// block, the block of the tile where the run starts: it finds the tiles
// the run spans (the following tiles whose slot 0 holds its id), sums
// their carries with all its threads in a fixed order (TILE / C groups of
// C columns, group g taking carries g, g + groups, ...; then the groups'
// sums in group order) and writes the row.  Every tile block does the same
// work whatever the ids; no thread walks a run; each row is written once,
// by one thread, in a sum order fixed by the ids alone, so a run gives the
// same bits every time, in a CUDA graph as eagerly.
//
// What bounds it: bytes.  grad_out read once (N x C values), the ids and
// lanes once (12 B a lane), each touched row written once; the rows not
// touched are the wrapper's zeros.  The carries are a few KB.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 256            // sorted positions a block, one a thread (ops/gather.py:TILE)
#define WARPS (TILE / 32)
#define CHUNK 16            // columns staged at a time
#define FULL 0xffffffffu

namespace {

// Inclusive segmented scan across a warp: v becomes the sum of the values
// from the last head at or before this lane (f: this lane is a head).
template <typename T>
__device__ __forceinline__ T warp_segmented_scan(T v, int f, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const T up = __shfl_up_sync(FULL, v, d);
        const int f_up = __shfl_up_sync(FULL, f, d);
        if (lane >= d) {
            if (!f) v = up + v;
            f |= f_up;
        }
    }
    return v;
}

template <typename T>
__global__ void __launch_bounds__(TILE)
row_gather_bwd_tile(const int* __restrict__ keys, const long long* __restrict__ lanes,
                    const T* __restrict__ grad, T* __restrict__ out, T* __restrict__ carry,
                    int* __restrict__ carry_id, int n, int cols) {
    __shared__ int s_key[TILE];
    __shared__ long long s_lane[TILE];
    __shared__ T s_val[TILE * (CHUNK + 1)];
    __shared__ T s_total[CHUNK][WARPS];
    __shared__ int s_head[WARPS];
    const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
    const int tile = blockIdx.x;
    const int start = tile * TILE;
    const int cnt = min(TILE, n - start);
    const bool valid = i < cnt;
    const int key = valid ? keys[start + i] : -1;
    s_key[i] = key;
    s_lane[i] = valid ? lanes[start + i] : 0;
    __syncthreads();

    const int first = s_key[0], last = s_key[cnt - 1];
    const bool cut_before = start > 0 && keys[start - 1] == first;
    const bool cut_after = start + cnt < n && keys[start + cnt] == last;
    // a head starts a run inside the tile; positions past n are heads too,
    // with value 0, after every valid one
    const int head = !valid || i == 0 || s_key[i - 1] != key;
    const bool run_end = valid && (i == cnt - 1 || s_key[i + 1] != key);
    const unsigned heads = __ballot_sync(FULL, head);
    if (lane == 0) s_head[warp] = heads != 0;
    // whether a head lies between the warp's first lane and this one
    const bool headed = (heads & (FULL >> (31 - lane))) != 0;
    const bool in_first = key == first;
    const bool cut = run_end && ((in_first && cut_before) || (i == cnt - 1 && cut_after));
    if (i == 0) {
        const bool single = first == last;
        carry_id[2 * tile] = (cut_before || (single && cut_after)) ? first : -1;
        carry_id[2 * tile + 1] = (!single && cut_after) ? last : -1;
    }

    for (int c0 = 0; c0 < cols; c0 += CHUNK) {
        const int w = min(CHUNK, cols - c0);
        for (int k = i; k < cnt * w; k += TILE) {
            const int p = k / w, c = k - p * w;
            s_val[p * (CHUNK + 1) + c] = grad[s_lane[p] * cols + c0 + c];
        }
        __syncthreads();
        T v[CHUNK];
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
            if (c < w) {
                v[c] = warp_segmented_scan(valid ? s_val[i * (CHUNK + 1) + c] : T(0), head,
                                           lane);
                if (lane == 31) s_total[c][warp] = v[c];
            }
        }
        __syncthreads();
        if (!headed) {
            // the run began in an earlier warp: add the warps' totals in
            // warp order, restarting at each warp that holds a head
#pragma unroll
            for (int c = 0; c < CHUNK; ++c) {
                if (c < w) {
                    T p = T(0);
                    for (int k = 0; k < warp; ++k)
                        p = s_head[k] ? s_total[c][k] : p + s_total[c][k];
                    v[c] = p + v[c];
                }
            }
        }
        if (run_end) {
            T* dst = cut ? carry + (size_t)(2 * tile + (in_first ? 0 : 1)) * cols + c0
                         : out + (size_t)key * cols + c0;
#pragma unroll
            for (int c = 0; c < CHUNK; ++c)
                if (c < w) dst[c] = v[c];
        }
        __syncthreads();
    }
}

template <typename T>
__global__ void __launch_bounds__(TILE)
row_gather_bwd_carry(const int* __restrict__ keys, const T* __restrict__ carry,
                     const int* __restrict__ carry_id, T* __restrict__ out, int tiles,
                     int cols) {
    __shared__ int s_count;
    __shared__ T s_part[TILE];
    const int tile = blockIdx.x, i = threadIdx.x;
    // the run that starts in this tile and is cut at its end: slot 1, or
    // slot 0 when the tile is one run that does not continue an earlier one
    const int id1 = carry_id[2 * tile + 1], id0 = carry_id[2 * tile];
    int slot, id;
    if (id1 >= 0) {
        slot = 1;
        id = id1;
    } else if (id0 >= 0 && !(tile > 0 && keys[tile * TILE - 1] == id0)) {
        slot = 0;
        id = id0;
    } else {
        return;   // the whole block: no run starts here cut
    }
    // the run's carries: this tile's, then slot 0 of each following tile
    // that holds its id (ids are sorted, so those tiles are consecutive);
    // the first warp counts them
    if (i < 32) {
        int count = 1;
        for (int base = tile + 1; base < tiles; base += 32) {
            const int t = base + i;
            const unsigned m = __ballot_sync(FULL, t < tiles && carry_id[2 * t] == id);
            const int more = m == FULL ? 32 : __ffs(~m) - 1;
            count += more;
            if (more < 32) break;
        }
        if (i == 0) s_count = count;
    }
    __syncthreads();
    const int count = s_count;
    // thread (g, c) of `groups` groups of w columns sums carries g, g +
    // groups, ... of column c in that order; then thread c adds the
    // groups' sums in group order
    for (int c0 = 0; c0 < cols; c0 += TILE) {
        const int w = min(TILE, cols - c0);
        const int groups = TILE / w;
        const int g = i / w, c = i - g * w;
        T s = T(0);
        if (g < groups) {
#pragma unroll 4
            for (int j = g; j < count; j += groups) {
                const int e = j == 0 ? 2 * tile + slot : 2 * (tile + j);
                s += carry[(size_t)e * cols + c0 + c];
            }
        }
        s_part[i] = s;
        __syncthreads();
        if (i < w) {
            T total = T(0);
            for (int k = 0; k < groups; ++k) total += s_part[k * w + i];
            out[(size_t)id * cols + c0 + i] = total;
        }
        __syncthreads();
    }
}

template <typename T>
int launch(const void* keys, const void* lanes, const void* grad, void* out, void* carry,
           void* carry_id, int n, int cols, cudaStream_t stream) {
    const int tiles = (n + TILE - 1) / TILE;
    row_gather_bwd_tile<T><<<tiles, TILE, 0, stream>>>(
        static_cast<const int*>(keys), static_cast<const long long*>(lanes),
        static_cast<const T*>(grad), static_cast<T*>(out), static_cast<T*>(carry),
        static_cast<int*>(carry_id), n, cols);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    row_gather_bwd_carry<T><<<tiles, TILE, 0, stream>>>(
        static_cast<const int*>(keys), static_cast<const T*>(carry),
        static_cast<const int*>(carry_id), static_cast<T*>(out), tiles, cols);
    return (int)cudaGetLastError();
}

int attrs_of(const void* fn, int* out) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    return 0;
}

}  // namespace

// keys: (n,) int32 sorted ids; lanes: (n,) int64, the lane of each sorted
// position; grad: (n, cols) contiguous; out: (rows, cols), zeros; carry:
// (2 * tiles, cols); carry_id: (2 * tiles,) int32; double_: 0 for float32,
// 1 for float64.  Launches the tile kernel, then the carry kernel; returns
// the first launch error.
extern "C" int rrt_row_gather_bwd(const void* keys, const void* lanes, const void* grad,
                                  void* out, void* carry, void* carry_id, int n, int cols,
                                  int double_, cudaStream_t stream) {
    if (n <= 0 || cols <= 0) return 0;
    return double_ ? launch<double>(keys, lanes, grad, out, carry, carry_id, n, cols, stream)
                   : launch<float>(keys, lanes, grad, out, carry, carry_id, n, cols, stream);
}

extern "C" int rrt_row_gather_bwd_attrs(int* out) {
    return attrs_of((const void*)row_gather_bwd_tile<float>, out);
}

extern "C" int rrt_row_gather_bwd_carry_attrs(int* out) {
    return attrs_of((const void*)row_gather_bwd_carry<float>, out);
}
