// Host-side native runtime of gtsam_points_tpu_torch: fast binary IO, an
// exact KdTree kNN, and voxel-grid downsampling for the data-loading and
// preprocessing path (the role the reference's C++ host library plays around
// its device kernels; cf. the reference's include/gtsam_points/util/
// read_points.hpp and include/gtsam_points/ann/small_kdtree.hpp). The port's
// own copy of the JAX package's native/src/host_ops.cpp: every function body
// is the same, so the two libraries compute the same results bit for bit.
// An iterative nth_element build, array-based stack traversal, a C ABI.
//
// Built by g++ at first use and loaded with ctypes
// (gtsam_points_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- binary IO
// Returns number of floats read, or -1 on failure. buf may be nullptr to query size.
int64_t gpt_read_floats(const char* path, float* buf, int64_t capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const int64_t bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  const int64_t n = bytes / static_cast<int64_t>(sizeof(float));
  if (buf != nullptr) {
    const int64_t to_read = std::min(n, capacity);
    const size_t got = std::fread(buf, sizeof(float), static_cast<size_t>(to_read), f);
    std::fclose(f);
    return static_cast<int64_t>(got);
  }
  std::fclose(f);
  return n;
}

// ------------------------------------------------------------------- KdTree
// Flat-array KdTree over [N,3] points. Build: recursive median split via
// nth_element on an index array, splitting on the largest-spread axis.

struct KdNode {
  int32_t left;    // child node index or -1
  int32_t right;   // child node index or -1
  int32_t index;   // point index (leaf and internal store their median point)
  int32_t axis;
  float split;
};

struct KdTree {
  std::vector<KdNode> nodes;
  const float* pts;  // borrowed [N,3]
  int64_t n;
  int32_t root;
};

static int32_t kd_build(KdTree& t, std::vector<int32_t>& idx, int64_t lo, int64_t hi) {
  if (lo >= hi) return -1;
  // pick axis with largest extent
  float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = lo; i < hi; i++) {
    const float* p = t.pts + 3 * idx[i];
    for (int a = 0; a < 3; a++) {
      mn[a] = std::min(mn[a], p[a]);
      mx[a] = std::max(mx[a], p[a]);
    }
  }
  int axis = 0;
  float best = mx[0] - mn[0];
  for (int a = 1; a < 3; a++) {
    if (mx[a] - mn[a] > best) { best = mx[a] - mn[a]; axis = a; }
  }
  const int64_t mid = (lo + hi) / 2;
  std::nth_element(idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
                   [&](int32_t a, int32_t b) { return t.pts[3 * a + axis] < t.pts[3 * b + axis]; });
  KdNode node;
  node.index = idx[mid];
  node.axis = axis;
  node.split = t.pts[3 * idx[mid] + axis];
  const int32_t self = static_cast<int32_t>(t.nodes.size());
  t.nodes.push_back(node);
  const int32_t l = kd_build(t, idx, lo, mid);
  const int32_t r = kd_build(t, idx, mid + 1, hi);
  t.nodes[self].left = l;
  t.nodes[self].right = r;
  return self;
}

void* gpt_kdtree_build(const float* pts, int64_t n) {
  KdTree* t = new KdTree();
  t->pts = pts;
  t->n = n;
  t->nodes.reserve(static_cast<size_t>(n));
  std::vector<int32_t> idx(static_cast<size_t>(n));
  std::iota(idx.begin(), idx.end(), 0);
  t->root = kd_build(*t, idx, 0, n);
  return t;
}

void gpt_kdtree_free(void* handle) { delete static_cast<KdTree*>(handle); }

// kNN for Q queries; writes indices [Q,k] and sq dists [Q,k]; missing = -1/inf.
void gpt_kdtree_knn(void* handle, const float* queries, int64_t q, int32_t k,
                    int32_t* out_idx, float* out_sq) {
  const KdTree& t = *static_cast<KdTree*>(handle);
  std::vector<std::pair<float, int32_t>> heap;  // max-heap on distance
  std::vector<int32_t> stack;
  for (int64_t qi = 0; qi < q; qi++) {
    const float* query = queries + 3 * qi;
    heap.clear();
    stack.clear();
    stack.push_back(t.root);
    while (!stack.empty()) {
      const int32_t ni = stack.back();
      stack.pop_back();
      if (ni < 0) continue;
      const KdNode& node = t.nodes[static_cast<size_t>(ni)];
      const float* p = t.pts + 3 * node.index;
      const float dx = p[0] - query[0], dy = p[1] - query[1], dz = p[2] - query[2];
      const float sq = dx * dx + dy * dy + dz * dz;
      if (static_cast<int32_t>(heap.size()) < k) {
        heap.emplace_back(sq, node.index);
        std::push_heap(heap.begin(), heap.end());
      } else if (sq < heap.front().first) {
        std::pop_heap(heap.begin(), heap.end());
        heap.back() = {sq, node.index};
        std::push_heap(heap.begin(), heap.end());
      }
      const float diff = query[node.axis] - node.split;
      const int32_t near = diff <= 0 ? node.left : node.right;
      const int32_t far = diff <= 0 ? node.right : node.left;
      const float worst = static_cast<int32_t>(heap.size()) < k ? 1e30f : heap.front().first;
      if (diff * diff < worst) stack.push_back(far);
      stack.push_back(near);
    }
    std::sort_heap(heap.begin(), heap.end());
    for (int32_t j = 0; j < k; j++) {
      if (j < static_cast<int32_t>(heap.size())) {
        out_idx[qi * k + j] = heap[static_cast<size_t>(j)].second;
        out_sq[qi * k + j] = heap[static_cast<size_t>(j)].first;
      } else {
        out_idx[qi * k + j] = -1;
        out_sq[qi * k + j] = 1e30f;
      }
    }
  }
}

// ---------------------------------------------------- voxel-grid downsample
// Averages points per voxel. Returns number of output points (<= capacity).
int64_t gpt_voxelgrid(const float* pts, int64_t n, float leaf, float* out, int64_t capacity) {
  struct Key {
    int32_t x, y, z;
    bool operator==(const Key& o) const { return x == o.x && y == o.y && z == o.z; }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      // same XOR/prime mix family as the reference's vector3i_hash
      return static_cast<size_t>(k.x * 73856093 ^ k.y * 19349669 ^ k.z * 83492791);
    }
  };
  std::unordered_map<Key, std::pair<int64_t, int64_t>, KeyHash> cells;  // key -> (slot, count)
  std::vector<double> acc;
  const float inv = 1.0f / leaf;
  for (int64_t i = 0; i < n; i++) {
    const float* p = pts + 3 * i;
    Key key{static_cast<int32_t>(std::floor(p[0] * inv)),
            static_cast<int32_t>(std::floor(p[1] * inv)),
            static_cast<int32_t>(std::floor(p[2] * inv))};
    auto it = cells.find(key);
    if (it == cells.end()) {
      const int64_t slot = static_cast<int64_t>(cells.size());
      if (slot >= capacity) continue;
      cells.emplace(key, std::make_pair(slot, int64_t{1}));
      acc.resize(static_cast<size_t>(3 * (slot + 1)), 0.0);
      for (int a = 0; a < 3; a++) acc[static_cast<size_t>(3 * slot + a)] = p[a];
    } else {
      it->second.second++;
      const int64_t slot = it->second.first;
      for (int a = 0; a < 3; a++) acc[static_cast<size_t>(3 * slot + a)] += p[a];
    }
  }
  for (const auto& kv : cells) {
    const int64_t slot = kv.second.first;
    const double cnt = static_cast<double>(kv.second.second);
    for (int a = 0; a < 3; a++)
      out[3 * slot + a] = static_cast<float>(acc[static_cast<size_t>(3 * slot + a)] / cnt);
  }
  return static_cast<int64_t>(cells.size());
}

}  // extern "C"
