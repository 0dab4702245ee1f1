// Native BVH builder: binned surface-area-heuristic construction.
//
// The runtime-native tier of the acceleration-structure layer (the
// reference keeps its builder on the host too — C# BVHGenerator.cs; SAH is
// its own listed TODO, HalgoenCompute.compute:16). Node layout matches the
// flat BVHEntry consumed by the traversal kernels: (aabb_lo, aabb_hi,
// index_a, count) with count > 0 marking a leaf and children contiguous
// (childB = childA + 1).
//
// Exposed as a C ABI for ctypes; built once via g++ -O3 -shared.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumBins = 16;
constexpr float kAabbEps = 1e-5f;  // thin-geometry epsilon (RayTracingMesh.cs:11)

struct Vec3 {
  float x, y, z;
};

struct Aabb {
  float lo[3];
  float hi[3];
  void reset() {
    for (int k = 0; k < 3; ++k) { lo[k] = FLT_MAX; hi[k] = -FLT_MAX; }
  }
  void grow(const float* p) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], p[k]);
      hi[k] = std::max(hi[k], p[k]);
    }
  }
  void grow(const Aabb& o) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], o.lo[k]);
      hi[k] = std::max(hi[k], o.hi[k]);
    }
  }
  float area() const {
    float dx = std::max(hi[0] - lo[0], 0.f);
    float dy = std::max(hi[1] - lo[1], 0.f);
    float dz = std::max(hi[2] - lo[2], 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
  void pad_thin() {
    for (int k = 0; k < 3; ++k) {
      if (hi[k] - lo[k] < kAabbEps) hi[k] += kAabbEps;
    }
  }
};

struct BuildTask {
  int node;
  int start;
  int count;
  int depth;
};

}  // namespace

extern "C" {

// tris: [n, 3, 3] float32 triangle vertices.
// Outputs (caller-allocated, capacity 2n nodes):
//   lo/hi: [cap, 3], index_a/count: [cap], order: [n] (old index of the
//   triangle now at slot i), depth_out: max depth reached.
// Returns the number of nodes written, or -1 on overflow.
int32_t halogen_build_bvh_sah(const float* tris, int32_t n,
                              int32_t max_leaf, int32_t max_depth,
                              float* lo_out, float* hi_out,
                              int32_t* index_a_out, int32_t* count_out,
                              int32_t* order_out, int32_t node_capacity,
                              int32_t* depth_out) {
  if (n <= 0) {
    if (node_capacity < 1) return -1;
    std::memset(lo_out, 0, 3 * sizeof(float));
    std::memset(hi_out, 0, 3 * sizeof(float));
    index_a_out[0] = 0;
    count_out[0] = 0;
    *depth_out = 0;
    return 1;
  }

  std::vector<Aabb> tri_bounds(n);
  std::vector<Vec3> centroids(n);
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; ++i) {
    const float* t = tris + size_t(i) * 9;
    Aabb b;
    b.reset();
    b.grow(t);
    b.grow(t + 3);
    b.grow(t + 6);
    tri_bounds[i] = b;
    centroids[i] = {(t[0] + t[3] + t[6]) / 3.f,
                    (t[1] + t[4] + t[7]) / 3.f,
                    (t[2] + t[5] + t[8]) / 3.f};
    order[i] = i;
  }

  int32_t num_nodes = 0;
  auto alloc_node = [&]() -> int32_t {
    if (num_nodes >= node_capacity) return -1;
    return num_nodes++;
  };

  auto node_bounds = [&](int32_t start, int32_t count) {
    Aabb b;
    b.reset();
    for (int32_t i = start; i < start + count; ++i)
      b.grow(tri_bounds[order[i]]);
    b.pad_thin();
    return b;
  };

  int32_t root = alloc_node();
  Aabb root_b = node_bounds(0, n);
  std::memcpy(lo_out + root * 3, root_b.lo, 3 * sizeof(float));
  std::memcpy(hi_out + root * 3, root_b.hi, 3 * sizeof(float));
  index_a_out[root] = 0;
  count_out[root] = n;

  std::vector<BuildTask> stack;
  stack.push_back({root, 0, n, 0});
  int32_t max_depth_used = 0;
  std::vector<int32_t> scratch;

  while (!stack.empty()) {
    BuildTask task = stack.back();
    stack.pop_back();
    max_depth_used = std::max(max_depth_used, task.depth);
    if (task.count <= max_leaf || task.depth >= max_depth) continue;

    // Centroid bounds choose the split axis.
    Aabb cb;
    cb.reset();
    for (int32_t i = task.start; i < task.start + task.count; ++i)
      cb.grow(&centroids[order[i]].x);
    int axis = 0;
    float ext[3] = {cb.hi[0] - cb.lo[0], cb.hi[1] - cb.lo[1],
                    cb.hi[2] - cb.lo[2]};
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int32_t mid;
    if (ext[axis] < 1e-12f) {
      mid = task.start + task.count / 2;  // degenerate: median split
    } else {
      // Binned SAH sweep.
      Aabb bin_b[kNumBins];
      int32_t bin_n[kNumBins];
      for (int b = 0; b < kNumBins; ++b) {
        bin_b[b].reset();
        bin_n[b] = 0;
      }
      const float k1 = kNumBins * (1.f - 1e-6f) / ext[axis];
      const float c0 = cb.lo[axis];
      auto bin_of = [&](int32_t tri) {
        float c = (&centroids[tri].x)[axis];
        int b = int(k1 * (c - c0));
        return std::min(std::max(b, 0), kNumBins - 1);
      };
      for (int32_t i = task.start; i < task.start + task.count; ++i) {
        int b = bin_of(order[i]);
        bin_b[b].grow(tri_bounds[order[i]]);
        bin_n[b] += 1;
      }
      // Suffix sweep
      Aabb right_acc;
      right_acc.reset();
      float right_area[kNumBins];
      int32_t right_cnt[kNumBins];
      int32_t acc_n = 0;
      for (int b = kNumBins - 1; b >= 1; --b) {
        right_acc.grow(bin_b[b]);
        acc_n += bin_n[b];
        right_area[b] = acc_n ? right_acc.area() : 0.f;
        right_cnt[b] = acc_n;
      }
      // Prefix sweep + cost
      Aabb left_acc;
      left_acc.reset();
      int32_t left_n = 0;
      float best_cost = FLT_MAX;
      int best_split = -1;
      for (int b = 0; b < kNumBins - 1; ++b) {
        left_acc.grow(bin_b[b]);
        left_n += bin_n[b];
        if (left_n == 0 || right_cnt[b + 1] == 0) continue;
        float cost = left_acc.area() * left_n
                   + right_area[b + 1] * right_cnt[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_split = b;
        }
      }
      // Leaf cost vs split cost (standard SAH leaf criterion)
      Aabb self_b = node_bounds(task.start, task.count);
      float leaf_cost = self_b.area() * task.count;
      if (best_split < 0 ||
          (best_cost >= leaf_cost && task.count <= 2 * max_leaf)) {
        mid = task.start + task.count / 2;  // force progress on big nodes
        if (best_split < 0 && task.count <= max_leaf) continue;
      } else {
        // Partition by bin
        scratch.clear();
        scratch.reserve(task.count);
        int32_t w = task.start;
        for (int32_t i = task.start; i < task.start + task.count; ++i) {
          if (bin_of(order[i]) <= best_split) order[w++] = order[i];
          else scratch.push_back(order[i]);
        }
        std::memcpy(order.data() + w, scratch.data(),
                    scratch.size() * sizeof(int32_t));
        mid = w;
      }
    }
    if (mid <= task.start || mid >= task.start + task.count)
      mid = task.start + task.count / 2;
    if (mid <= task.start || mid >= task.start + task.count) continue;

    int32_t child_a = alloc_node();
    int32_t child_b = alloc_node();
    if (child_a < 0 || child_b < 0) return -1;

    int32_t n_left = mid - task.start;
    int32_t n_right = task.count - n_left;
    Aabb ba = node_bounds(task.start, n_left);
    Aabb bb = node_bounds(mid, n_right);
    std::memcpy(lo_out + child_a * 3, ba.lo, 3 * sizeof(float));
    std::memcpy(hi_out + child_a * 3, ba.hi, 3 * sizeof(float));
    index_a_out[child_a] = task.start;
    count_out[child_a] = n_left;
    std::memcpy(lo_out + child_b * 3, bb.lo, 3 * sizeof(float));
    std::memcpy(hi_out + child_b * 3, bb.hi, 3 * sizeof(float));
    index_a_out[child_b] = mid;
    count_out[child_b] = n_right;

    // Promote parent to inner node
    index_a_out[task.node] = child_a;
    count_out[task.node] = 0;

    stack.push_back({child_a, task.start, n_left, task.depth + 1});
    stack.push_back({child_b, mid, n_right, task.depth + 1});
  }

  std::memcpy(order_out, order.data(), n * sizeof(int32_t));
  *depth_out = max_depth_used;
  return num_nodes;
}

}  // extern "C"
