// Native scene-build core: binned-SAH BVH builder.
//
// Replaces the host-side hot loops of the reference's acceleration build
// (reference: src/object/mesh/octree.rs — per-mesh octree over up to 870k
// triangles; src/object/bvh.rs — random-axis median-split object BVH) with a
// single binned-SAH BVH over ALL world-space triangles, emitted directly in
// the threaded flat layout the TPU traversal consumes (DFS preorder with
// hit/miss skip links; fixed-size padded leaves).
//
// Exposed as a C ABI consumed from Python via ctypes
// (rust_raytracer_torch/native/__init__.py;
// the port's copy of rust_raytracer_tpu/native/).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr int kNumBins = 16;
constexpr float kInf = std::numeric_limits<float>::infinity();

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float axis_of(const Vec3 &v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}

struct Aabb {
  Vec3 lo{kInf, kInf, kInf};
  Vec3 hi{-kInf, -kInf, -kInf};
  void grow(const Aabb &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.0f);
    float dy = std::max(hi.y - lo.y, 0.0f);
    float dz = std::max(hi.z - lo.z, 0.0f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct BuildNode {
  Aabb box;
  int32_t left = -1;   // index into nodes; -1 for leaf
  int32_t right = -1;
  int64_t first = 0;   // leaf: first index into prim order
  int64_t count = 0;   // leaf: number of prims
};

struct Builder {
  const float *tri_min;
  const float *tri_max;
  int64_t n;
  int leaf_size;

  std::vector<Aabb> boxes;
  std::vector<Vec3> centroids;
  std::vector<int64_t> order;
  std::vector<BuildNode> nodes;

  Aabb prim_box(int64_t i) const { return boxes[i]; }

  int32_t build(int64_t start, int64_t end) {
    BuildNode node;
    for (int64_t i = start; i < end; ++i) node.box.grow(boxes[order[i]]);
    int64_t count = end - start;
    int32_t idx = (int32_t)nodes.size();
    nodes.push_back(node);

    if (count <= leaf_size) {
      nodes[idx].first = start;
      nodes[idx].count = count;
      return idx;
    }

    // centroid bounds choose the split axis
    Aabb cb;
    for (int64_t i = start; i < end; ++i) cb.grow(centroids[order[i]]);
    int axis = 0;
    {
      float dx = cb.hi.x - cb.lo.x, dy = cb.hi.y - cb.lo.y,
            dz = cb.hi.z - cb.lo.z;
      if (dy > dx) axis = 1;
      if (dz > axis_of({dx, dy, dz}, axis)) axis = 2;
    }
    float cmin = axis_of(cb.lo, axis), cmax = axis_of(cb.hi, axis);

    int64_t mid;
    if (cmax - cmin < 1e-12f) {
      mid = start + count / 2;  // degenerate spread: median split
    } else {
      // binned SAH
      Aabb bin_box[kNumBins];
      int64_t bin_cnt[kNumBins] = {0};
      float scale = kNumBins / (cmax - cmin);
      auto bin_of = [&](int64_t prim) {
        int b = (int)((axis_of(centroids[prim], axis) - cmin) * scale);
        return std::min(std::max(b, 0), kNumBins - 1);
      };
      for (int64_t i = start; i < end; ++i) {
        int b = bin_of(order[i]);
        bin_box[b].grow(boxes[order[i]]);
        bin_cnt[b]++;
      }
      // sweep: cost(split after bin k) = A_l*n_l + A_r*n_r
      float right_area[kNumBins];
      Aabb acc;
      int64_t right_cnt[kNumBins];
      int64_t rc = 0;
      for (int k = kNumBins - 1; k >= 1; --k) {
        acc.grow(bin_box[k]);
        rc += bin_cnt[k];
        right_area[k] = acc.half_area();
        right_cnt[k] = rc;
      }
      Aabb lacc;
      int64_t lc = 0;
      float best_cost = kInf;
      int best_k = -1;
      for (int k = 0; k < kNumBins - 1; ++k) {
        lacc.grow(bin_box[k]);
        lc += bin_cnt[k];
        if (lc == 0 || right_cnt[k + 1] == 0) continue;
        float cost = lacc.half_area() * lc + right_area[k + 1] * right_cnt[k + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_k = k;
        }
      }
      if (best_k < 0) {
        mid = start + count / 2;
      } else {
        auto it = std::partition(
            order.begin() + start, order.begin() + end,
            [&](int64_t prim) { return bin_of(prim) <= best_k; });
        mid = it - order.begin();
        if (mid == start || mid == end) mid = start + count / 2;
      }
    }

    int32_t l = build(start, mid);
    int32_t r = build(mid, end);
    nodes[idx].left = l;
    nodes[idx].right = r;
    return idx;
  }
};

// Flattened threaded output, preorder with skip links.
struct FlatBVH {
  std::vector<float> node_min, node_max;  // (M, 3)
  std::vector<int32_t> hit_link, miss_link, leaf_start;
  std::vector<int64_t> tri_order;  // padded slots; -1 = degenerate padding
};

struct Handle {
  FlatBVH flat;
};

// Two-pass flatten: pass 1 computes subtree sizes, pass 2 emits preorder
// nodes with exact hit/miss skip offsets.
void subtree_sizes(const Builder &b, int32_t node, std::vector<int32_t> &sz) {
  const BuildNode &n = b.nodes[node];
  if (n.left < 0) {
    sz[node] = 1;
    return;
  }
  subtree_sizes(b, n.left, sz);
  subtree_sizes(b, n.right, sz);
  sz[node] = 1 + sz[n.left] + sz[n.right];
}

void emit(const Builder &b, int32_t node, int32_t miss,
          const std::vector<int32_t> &sz, FlatBVH &out, int leaf_size) {
  const BuildNode &n = b.nodes[node];
  int32_t me = (int32_t)(out.leaf_start.size());
  out.node_min.insert(out.node_min.end(), {n.box.lo.x, n.box.lo.y, n.box.lo.z});
  out.node_max.insert(out.node_max.end(), {n.box.hi.x, n.box.hi.y, n.box.hi.z});
  out.miss_link.push_back(miss);
  if (n.left < 0) {
    int32_t slot0 = (int32_t)out.tri_order.size();
    out.leaf_start.push_back(slot0);
    out.hit_link.push_back(miss);  // after a leaf, continue at miss
    for (int64_t i = 0; i < n.count; ++i)
      out.tri_order.push_back(b.order[n.first + i]);
    for (int64_t i = n.count; i < leaf_size; ++i) out.tri_order.push_back(-1);
  } else {
    out.leaf_start.push_back(-1);
    out.hit_link.push_back(me + 1);  // descend into left child
    int32_t right_pos = me + 1 + sz[n.left];
    emit(b, n.left, right_pos, sz, out, leaf_size);
    emit(b, n.right, miss, sz, out, leaf_size);
  }
}

}  // namespace

extern "C" {

void *rrt_bvh_build(const float *tri_min, const float *tri_max, int64_t n,
                    int32_t leaf_size) {
  if (n <= 0 || leaf_size <= 0) return nullptr;
  Builder b;
  b.tri_min = tri_min;
  b.tri_max = tri_max;
  b.n = n;
  b.leaf_size = leaf_size;
  b.boxes.resize(n);
  b.centroids.resize(n);
  b.order.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    Vec3 lo{tri_min[3 * i], tri_min[3 * i + 1], tri_min[3 * i + 2]};
    Vec3 hi{tri_max[3 * i], tri_max[3 * i + 1], tri_max[3 * i + 2]};
    b.boxes[i].lo = lo;
    b.boxes[i].hi = hi;
    b.centroids[i] = {0.5f * (lo.x + hi.x), 0.5f * (lo.y + hi.y),
                      0.5f * (lo.z + hi.z)};
    b.order[i] = i;
  }
  b.nodes.reserve((size_t)(2 * n / leaf_size + 16));
  int32_t root = b.build(0, n);

  std::vector<int32_t> sz(b.nodes.size(), 0);
  subtree_sizes(b, root, sz);

  auto *h = new Handle();
  h->flat.node_min.reserve(3 * sz[root]);
  h->flat.node_max.reserve(3 * sz[root]);
  h->flat.hit_link.reserve(sz[root]);
  h->flat.miss_link.reserve(sz[root]);
  h->flat.leaf_start.reserve(sz[root]);
  // sentinel miss == number of flat nodes (loop termination in traversal)
  emit(b, root, sz[root], sz, h->flat, leaf_size);
  return h;
}

void rrt_bvh_counts(void *handle, int64_t *n_nodes, int64_t *n_slots) {
  auto *h = (Handle *)handle;
  *n_nodes = (int64_t)h->flat.leaf_start.size();
  *n_slots = (int64_t)h->flat.tri_order.size();
}

void rrt_bvh_copy(void *handle, float *node_min, float *node_max,
                  int32_t *hit_link, int32_t *miss_link, int32_t *leaf_start,
                  int64_t *tri_order) {
  auto *h = (Handle *)handle;
  const FlatBVH &f = h->flat;
  std::memcpy(node_min, f.node_min.data(), f.node_min.size() * sizeof(float));
  std::memcpy(node_max, f.node_max.data(), f.node_max.size() * sizeof(float));
  std::memcpy(hit_link, f.hit_link.data(), f.hit_link.size() * sizeof(int32_t));
  std::memcpy(miss_link, f.miss_link.data(),
              f.miss_link.size() * sizeof(int32_t));
  std::memcpy(leaf_start, f.leaf_start.data(),
              f.leaf_start.size() * sizeof(int32_t));
  std::memcpy(tri_order, f.tri_order.data(),
              f.tri_order.size() * sizeof(int64_t));
}

void rrt_bvh_free(void *handle) { delete (Handle *)handle; }

}  // extern "C"
