// Native sweep-SAH BVH builder + per-octant skip-link threading.
//
// C++ implementation of the algorithm in scene/bvh.py (full-sweep surface
// area heuristic over all three axes, the approach of the reference's
// BVHBuilder, `Core/BVH/BVHBuilder.cpp:117-276` — fresh code, shared-library
// entry for the Python framework via ctypes).  ~100x faster than the numpy
// builder for Sponza-scale meshes; this is scene-load setup cost, exactly
// like `MeshShape::Initialize`.
//
// Built at first use by native/__init__.py (g++ -O3 -ffp-contract=off -shared -fPIC).
//
// Outputs match types.BVHFlat: packed (M,8) node boxes, per-node first
// padded-triangle slot (leaves own exactly LEAF_SIZE slots), 8 octant
// hit/miss link tables, the leaf-order permutation and padded slot ids.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kLeafSize = 4;

struct BuildNode {
  float bmin[3], bmax[3];
  int left = -1, right = -1;  // children (inner)
  int first = -1, count = 0;  // item range in permutation (leaf)
  int axis = 0;               // split axis (inner)
};

inline double SurfaceArea(const float* mn, const float* mx) {
  const double dx = mx[0] - mn[0], dy = mx[1] - mn[1], dz = mx[2] - mn[2];
  return 2.0 * (dx * dy + dy * dz + dz * dx);
}

struct Builder {
  const float* box_min;  // (n, 3)
  const float* box_max;
  int n;
  int max_leaf;

  std::vector<BuildNode> nodes;
  std::vector<int> perm;

  // scratch reused across nodes
  std::vector<uint8_t> in_left;
  std::vector<float> pre_min, pre_max, suf_min, suf_max;

  void Build() {
    std::vector<std::vector<int>> sorted(3);
    std::vector<float> centers(static_cast<size_t>(n) * 3);
    for (int i = 0; i < n; i++)
      for (int a = 0; a < 3; a++)
        centers[3 * i + a] = 0.5f * (box_min[3 * i + a] + box_max[3 * i + a]);
    for (int a = 0; a < 3; a++) {
      sorted[a].resize(n);
      for (int i = 0; i < n; i++) sorted[a][i] = i;
      std::stable_sort(sorted[a].begin(), sorted[a].end(), [&](int x, int y) {
        return centers[3 * x + a] < centers[3 * y + a];
      });
    }
    in_left.assign(n, 0);
    nodes.reserve(static_cast<size_t>(2) * n);
    perm.reserve(n);
    nodes.emplace_back();
    BuildNode_(0, std::move(sorted));
  }

  void BuildNode_(int node_idx, std::vector<std::vector<int>> idx_by_axis) {
    const std::vector<int>& idx = idx_by_axis[0];
    const int cnt = static_cast<int>(idx.size());

    float bmin[3] = {3e38f, 3e38f, 3e38f}, bmax[3] = {-3e38f, -3e38f, -3e38f};
    for (int id : idx)
      for (int a = 0; a < 3; a++) {
        bmin[a] = std::min(bmin[a], box_min[3 * id + a]);
        bmax[a] = std::max(bmax[a], box_max[3 * id + a]);
      }

    bool make_leaf = cnt <= max_leaf;
    double best_cost = 1e300;
    int best_axis = -1, best_k = -1;
    if (!make_leaf) {
      const double parent_sa = std::max(SurfaceArea(bmin, bmax), 1e-30);
      const double leaf_cost = parent_sa * cnt;
      pre_min.resize(static_cast<size_t>(cnt) * 3);
      pre_max.resize(static_cast<size_t>(cnt) * 3);
      suf_min.resize(static_cast<size_t>(cnt) * 3);
      suf_max.resize(static_cast<size_t>(cnt) * 3);
      for (int axis = 0; axis < 3; axis++) {
        const std::vector<int>& ids = idx_by_axis[axis];
        // prefix sweep
        for (int a = 0; a < 3; a++) {
          pre_min[a] = box_min[3 * ids[0] + a];
          pre_max[a] = box_max[3 * ids[0] + a];
        }
        for (int i = 1; i < cnt; i++)
          for (int a = 0; a < 3; a++) {
            pre_min[3 * i + a] = std::min(pre_min[3 * (i - 1) + a], box_min[3 * ids[i] + a]);
            pre_max[3 * i + a] = std::max(pre_max[3 * (i - 1) + a], box_max[3 * ids[i] + a]);
          }
        // suffix sweep
        for (int a = 0; a < 3; a++) {
          suf_min[3 * (cnt - 1) + a] = box_min[3 * ids[cnt - 1] + a];
          suf_max[3 * (cnt - 1) + a] = box_max[3 * ids[cnt - 1] + a];
        }
        for (int i = cnt - 2; i >= 0; i--)
          for (int a = 0; a < 3; a++) {
            suf_min[3 * i + a] = std::min(suf_min[3 * (i + 1) + a], box_min[3 * ids[i] + a]);
            suf_max[3 * i + a] = std::max(suf_max[3 * (i + 1) + a], box_max[3 * ids[i] + a]);
          }
        // exact SAH over every split position
        for (int k = 1; k < cnt; k++) {
          const double cost = SurfaceArea(&pre_min[3 * (k - 1)], &pre_max[3 * (k - 1)]) * k +
                              SurfaceArea(&suf_min[3 * k], &suf_max[3 * k]) * (cnt - k);
          if (cost < best_cost) {
            best_cost = cost;
            best_axis = axis;
            best_k = k;
          }
        }
      }
      if (best_cost >= leaf_cost && cnt <= 2 * max_leaf) make_leaf = true;
    }

    BuildNode& nd = nodes[node_idx];
    std::memcpy(nd.bmin, bmin, sizeof(bmin));
    std::memcpy(nd.bmax, bmax, sizeof(bmax));
    if (make_leaf) {
      nd.first = static_cast<int>(perm.size());
      nd.count = cnt;
      for (int id : idx) perm.push_back(id);
      return;
    }

    nd.axis = best_axis;
    for (int i = 0; i < best_k; i++) in_left[idx_by_axis[best_axis][i]] = 1;
    std::vector<std::vector<int>> left(3), right(3);
    for (int a = 0; a < 3; a++) {
      left[a].reserve(best_k);
      right[a].reserve(cnt - best_k);
      for (int id : idx_by_axis[a]) (in_left[id] ? left[a] : right[a]).push_back(id);
      idx_by_axis[a].clear();
      idx_by_axis[a].shrink_to_fit();
    }
    for (int i = 0; i < best_k; i++) in_left[left[0][i]] = 0;

    const int li = static_cast<int>(nodes.size());
    nodes.emplace_back();
    const int ri = static_cast<int>(nodes.size());
    nodes.emplace_back();
    nodes[node_idx].left = li;
    nodes[node_idx].right = ri;
    BuildNode_(li, std::move(left));
    BuildNode_(ri, std::move(right));
  }
};

}  // namespace

extern "C" {

// Pass 1: build the tree. Returns the node count (<= 2n-1), or -1 on error.
// Caller allocates outputs for the worst case:
//   nodes_box (2n, 8) f32 (lanes 6 and 7 zero); node_first (2n) i32;
//   perm (n) i32; padded_ids (4n) i32; out_num_padded: [0] = padded slot
//   count; node_left, node_right, node_axis (2n) i32: each node's children
//   (-1 at a leaf) and split axis, the input of bvh_thread_links.
int bvh_build(const float* box_min, const float* box_max, int n, int max_leaf,
              float* nodes_box, int* node_first, int* perm, int* padded_ids,
              int* out_num_padded, int* node_left, int* node_right, int* node_axis) {
  if (n <= 0) return -1;
  Builder b{box_min, box_max, n, max_leaf > 0 ? max_leaf : kLeafSize};
  b.Build();

  const int m = static_cast<int>(b.nodes.size());
  int cursor = 0;
  for (int i = 0; i < m; i++) {
    const BuildNode& nd = b.nodes[i];
    for (int a = 0; a < 3; a++) {
      nodes_box[8 * i + a] = nd.bmin[a];
      nodes_box[8 * i + 3 + a] = nd.bmax[a];
    }
    nodes_box[8 * i + 6] = 0.0f;
    nodes_box[8 * i + 7] = 0.0f;
    node_left[i] = nd.left;
    node_right[i] = nd.right;
    node_axis[i] = nd.axis;
    if (nd.left < 0) {  // leaf: pad to kLeafSize slots
      node_first[i] = cursor;
      for (int j = 0; j < kLeafSize; j++)
        padded_ids[cursor + j] = (j < nd.count) ? (nd.first + j) : -1;
      cursor += kLeafSize;
    } else {
      node_first[i] = -1;
    }
  }
  std::memcpy(perm, b.perm.data(), sizeof(int) * n);
  out_num_padded[0] = cursor;
  return m;
}

// Pass 2: thread hit/miss links for all 8 octants of the tree given by each
// node's left and right child (-1 at a leaf) and split axis, node 0 the
// root.  hit_links / miss_links are (8, m) i32.
void bvh_thread_links(const int* lefts, const int* rights, const int* axes, int m,
                      int* hit_links, int* miss_links) {
  std::vector<std::pair<int, int>> stack;
  stack.reserve(128);
  for (int octant = 0; octant < 8; octant++) {
    int* hit = hit_links + static_cast<size_t>(octant) * m;
    int* miss = miss_links + static_cast<size_t>(octant) * m;
    stack.clear();
    stack.push_back({0, -1});
    while (!stack.empty()) {
      auto [node, cont] = stack.back();
      stack.pop_back();
      miss[node] = cont;
      if (lefts[node] < 0) {  // leaf
        hit[node] = cont;
        continue;
      }
      int near = lefts[node], far = rights[node];
      if ((octant >> axes[node]) & 1) std::swap(near, far);
      hit[node] = near;
      stack.push_back({far, cont});
      stack.push_back({near, far});
    }
  }
}

}  // extern "C"
