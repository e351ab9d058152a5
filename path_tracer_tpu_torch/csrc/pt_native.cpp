// Host builder of path_tracer_tpu_torch: OBJ parsing, the binned-SAH BVH
// build and the walk engine's spatial chunk partition. Host C++ only (no
// CUDA): built with g++ by path_tracer_tpu_torch/native.py into _build/ and
// loaded through ctypes (a plain C ABI; no PyTorch headers).
//
// The reference implements these as Rust host code (load_obj at
// src/tlas/tlas_bvh/blas.rs:44-131; the SAH builder at
// src/tlas/tlas_bvh/blas/blas_bvh.rs:62-136). Python-level loops would
// dominate scene build time for large meshes (dragon-class, ~1M triangles).
//
// A copy of the JAX package's native/pt_native.cpp. Its output contract is
// that of the NumPy builders in path_tracer_tpu_torch/scene/{objio,bvh}.py
// (tests/test_torch_native.py holds it bit-equal to the JAX package's
// library and to the port's NumPy builders).

#include <algorithm>
#include <array>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <initializer_list>
#include <numeric>
#include <thread>
#include <utility>
#include <vector>

extern "C" {

void pt_free(void *p) { std::free(p); }

// ---------------------------------------------------------------- OBJ load

struct V3 {
  float x, y, z;
};

static inline V3 v3_sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 v3_cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// Parse an OBJ file with the same semantics as the Python loader
// (v/vn/f only, 1-based + negative indices, fan triangulation, face-normal
// fallback, vn normalized on load). Returns 0 on success.
// Outputs: *out_pos / *out_nrm are malloc'd [T*9] float arrays (T triangles,
// 3 vertices x 3 components); caller frees with pt_free.
int obj_load(const char *path, float **out_pos, float **out_nrm, int64_t *out_tris) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return 1;

  std::vector<V3> positions(1, V3{0, 0, 0});  // 1-based pad
  std::vector<V3> normals(1, V3{0, 0, 0});
  std::vector<float> tri_pos, tri_nrm;

  char line[8192];
  std::vector<std::pair<int64_t, int64_t>> refs;
  while (std::fgets(line, sizeof line, f)) {
    char *s = line;
    while (*s == ' ' || *s == '\t') s++;
    if (s[0] == 'v' && (s[1] == ' ' || s[1] == '\t')) {
      V3 p;
      if (std::sscanf(s + 1, "%f %f %f", &p.x, &p.y, &p.z) == 3) positions.push_back(p);
    } else if (s[0] == 'v' && s[1] == 'n' && (s[2] == ' ' || s[2] == '\t')) {
      V3 n;
      if (std::sscanf(s + 2, "%f %f %f", &n.x, &n.y, &n.z) == 3) {
        float len = std::sqrt(n.x * n.x + n.y * n.y + n.z * n.z);
        if (len > 0) {
          n.x /= len;
          n.y /= len;
          n.z /= len;
        }
        normals.push_back(n);
      }
    } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
      refs.clear();
      char *tok = s + 1;
      while (*tok) {
        while (*tok == ' ' || *tok == '\t') tok++;
        if (!*tok || *tok == '\n' || *tok == '\r') break;
        char *end = tok;
        while (*end && *end != ' ' && *end != '\t' && *end != '\n' && *end != '\r') end++;
        // token is tok..end: v[/vt[/vn]]
        int64_t v = std::strtoll(tok, nullptr, 10);
        int64_t vn = 0;
        char *slash = tok;
        int slashes = 0;
        while (slash < end) {
          if (*slash == '/') {
            slashes++;
            if (slashes == 2) vn = std::strtoll(slash + 1, nullptr, 10);
          }
          slash++;
        }
        if (v < 0) v = (int64_t)positions.size() + v;
        if (vn < 0) vn = (int64_t)normals.size() + vn;
        refs.emplace_back(v, vn);
        tok = end;
      }
      // fan triangulation (blas.rs:97-119 semantics)
      for (size_t i = 1; i + 1 < refs.size(); i++) {
        const std::pair<int64_t, int64_t> corner[3] = {refs[0], refs[i], refs[i + 1]};
        V3 p[3];
        for (int k = 0; k < 3; k++) p[k] = positions[(size_t)corner[k].first];
        V3 face_n = v3_cross(v3_sub(p[1], p[0]), v3_sub(p[2], p[0]));
        for (int k = 0; k < 3; k++) {
          V3 n = corner[k].second != 0 ? normals[(size_t)corner[k].second] : face_n;
          tri_pos.insert(tri_pos.end(), {p[k].x, p[k].y, p[k].z});
          tri_nrm.insert(tri_nrm.end(), {n.x, n.y, n.z});
        }
      }
    }
  }
  std::fclose(f);

  int64_t t = (int64_t)tri_pos.size() / 9;
  *out_tris = t;
  *out_pos = (float *)std::malloc(tri_pos.size() * sizeof(float));
  *out_nrm = (float *)std::malloc(tri_nrm.size() * sizeof(float));
  std::memcpy(*out_pos, tri_pos.data(), tri_pos.size() * sizeof(float));
  std::memcpy(*out_nrm, tri_nrm.data(), tri_nrm.size() * sizeof(float));
  return 0;
}

// ------------------------------------------------------------- SAH builder

namespace {

constexpr int kDesiredBins = 64;
constexpr float kTraversalCost = 1.0f;
constexpr float kIntersectionCost = 2.0f;

struct Box {
  float mn[3], mx[3];
  void reset() {
    for (int i = 0; i < 3; i++) {
      mn[i] = INFINITY;
      mx[i] = -INFINITY;
    }
  }
  void grow(const Box &o) {
    for (int i = 0; i < 3; i++) {
      mn[i] = std::min(mn[i], o.mn[i]);
      mx[i] = std::max(mx[i], o.mx[i]);
    }
  }
  float sa() const {
    float v0 = mx[0] - mn[0], v1 = mx[1] - mn[1], v2 = mx[2] - mn[2];
    return 2.0f * (v0 * v2 + v1 * v0 + v2 * v1);
  }
};

struct Node {
  Box box;
  bool leaf;
  int64_t a, b;  // leaf: (start,count); internal: (left,right) node ids
};

// Thread budget for the parallel builders. PT_NATIVE_THREADS overrides
// std::thread::hardware_concurrency(); subtree tasks below
// PT_NATIVE_PAR_MIN primitives (default 65536) build serially.
static int num_threads() {
  const char *e = std::getenv("PT_NATIVE_THREADS");
  if (e && *e) {
    int v = std::atoi(e);
    return v > 0 ? v : 1;
  }
  unsigned hw = std::thread::hardware_concurrency();
  return hw > 0 ? (int)hw : 1;
}

static int64_t parallel_min() {
  const char *e = std::getenv("PT_NATIVE_PAR_MIN");
  if (e && *e) {
    int64_t v = std::atoll(e);
    return v > 0 ? v : 1;
  }
  return 65536;
}

struct Builder {
  const float *bbmin, *bbmax;
  int64_t max_leaf;
  int64_t *perm;                 // shared primitive permutation (global ids)
  std::vector<Node> nodes;
  std::vector<Box> suffix;       // suffix accumulations (per-builder scratch)

  Box prim_box(int64_t id) const {
    Box b;
    for (int i = 0; i < 3; i++) {
      b.mn[i] = bbmin[id * 3 + i];
      b.mx[i] = bbmax[id * 3 + i];
    }
    return b;
  }

  // The single split decision, shared verbatim between the serial recursion
  // and the parallel top-level frontier so both produce identical trees.
  // Computes the range's bounds into node_box; returns -1 when the range
  // must become a leaf, else the split offset (left = [start, start+j)).
  // Side effect (same as the serial algorithm): stable-sorts perm[start,end)
  // by AABB min along the chosen axis.
  int64_t decide_split(int64_t start, int64_t end, Box &node_box) {
    int64_t span = end - start;
    node_box.reset();
    for (int64_t i = start; i < end; i++) node_box.grow(prim_box(perm[i]));

    if (span == 1) return -1;

    // longest axis of node bounds (blas_bvh.rs:82)
    int axis = 0;
    float best_len = node_box.mx[0] - node_box.mn[0];
    for (int i = 1; i < 3; i++) {
      float len = node_box.mx[i] - node_box.mn[i];
      if (len > best_len) {
        best_len = len;
        axis = i;
      }
    }

    // stable sort by AABB min along the axis (glidesort / stable argsort)
    std::stable_sort(
        perm + start, perm + end,
        [&](int64_t a, int64_t b) { return bbmin[a * 3 + axis] < bbmin[b * 3 + axis]; });

    // equal-count candidate splits (blas_bvh.rs:93-110)
    int64_t bin_size = std::max<int64_t>(span / kDesiredBins, 1);

    suffix.resize(span);
    Box acc;
    acc.reset();
    for (int64_t i = span - 1; i >= 0; i--) {
      acc.grow(prim_box(perm[start + i]));
      suffix[i] = acc;
    }

    // SAH evaluated in double with float32 surface areas — matches the
    // NumPy builder's NEP-50 promotion (int64 * float32 -> float64) so both
    // builders make identical split decisions.
    double bb_sa = std::max((double)node_box.sa(), 1e-30);
    double best_sah = INFINITY;
    int64_t best_split = bin_size;
    // candidate count matches the Python builder: (i+1)*bin_size for
    // i in [0, span/bin_size - 1), clipped to j < span
    int64_t candidates = std::max<int64_t>(span / bin_size - 1, 1);
    Box pre;
    pre.reset();
    int64_t next_candidate = bin_size;
    int64_t used = 0;
    for (int64_t j = 1; j < span && used < candidates; j++) {
      pre.grow(prim_box(perm[start + j - 1]));
      if (j == next_candidate) {
        double sah = (double)kTraversalCost +
                     ((double)j * (double)pre.sa() +
                      (double)(span - j) * (double)suffix[j].sa()) *
                         (double)kIntersectionCost / bb_sa;
        if (sah < best_sah) {
          best_sah = sah;
          best_split = j;
        }
        used++;
        next_candidate += bin_size;
      }
    }

    double no_split_sah = (double)kIntersectionCost * (double)span;
    if (no_split_sah < best_sah && span <= max_leaf) return -1;
    return best_split;
  }

  int64_t build(int64_t start, int64_t end) {
    Box node_box;
    int64_t split = decide_split(start, end, node_box);
    if (split < 0) {
      nodes.push_back({node_box, true, start, end - start});
      return (int64_t)nodes.size() - 1;
    }
    int64_t left = build(start, start + split);
    int64_t right = build(start + split, end);
    nodes.push_back({node_box, false, left, right});
    return (int64_t)nodes.size() - 1;
  }
};

// Parallel build: split the top of the tree serially (identical decisions —
// decide_split depends only on its own range) until there are enough
// independent subtree ranges, build each range in its own thread + node
// arena, then merge arenas with an index fixup. The output tree topology is
// bit-identical to the serial build; only internal node *ids* differ, which
// the DFS FlatWriter erases.
static int64_t build_toplevel(Builder &b, int64_t n) {
  int nthreads = num_threads();
  int64_t par_min = parallel_min();
  if (nthreads <= 1 || n < par_min) return b.build(0, n);

  // phase-1 tree over ranges: kind 0 = internal, 1 = leaf, 2 = pending task
  struct PN {
    Box box;
    int kind;
    int64_t a, c;  // internal: PN ids; leaf: (start,span); task: (start,end)
  };
  std::vector<PN> pns;
  pns.push_back({{}, 2, 0, n});
  std::vector<size_t> frontier{0};
  size_t target = (size_t)nthreads * 4;
  while (frontier.size() < target) {
    // split the largest pending range (order does not affect the result)
    size_t pick = 0;
    int64_t best_span = -1;
    for (size_t f = 0; f < frontier.size(); f++) {
      PN &p = pns[frontier[f]];
      int64_t span = p.c - p.a;
      if (span > best_span && span >= par_min) {
        best_span = span;
        pick = f;
      }
    }
    if (best_span < 0) break;  // nothing left worth splitting
    size_t id = frontier[pick];
    frontier[pick] = frontier.back();
    frontier.pop_back();
    int64_t start = pns[id].a, end = pns[id].c;
    Box node_box;
    int64_t split = b.decide_split(start, end, node_box);
    if (split < 0) {
      pns[id] = {node_box, 1, start, end - start};
      continue;
    }
    size_t left = pns.size();
    pns.push_back({{}, 2, start, start + split});
    size_t right = pns.size();
    pns.push_back({{}, 2, start + split, end});
    pns[id] = {node_box, 0, (int64_t)left, (int64_t)right};
    frontier.push_back(left);
    frontier.push_back(right);
  }

  // phase 2: build every pending task range in parallel, own arena each
  std::vector<size_t> tasks;
  for (size_t i = 0; i < pns.size(); i++)
    if (pns[i].kind == 2) tasks.push_back(i);
  std::vector<Builder> arenas(tasks.size());
  std::vector<int64_t> local_roots(tasks.size());
  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads; t++) {
    pool.emplace_back([&, t]() {
      for (size_t k = (size_t)t; k < tasks.size(); k += (size_t)nthreads) {
        Builder &lb = arenas[k];
        lb.bbmin = b.bbmin;
        lb.bbmax = b.bbmax;
        lb.max_leaf = b.max_leaf;
        lb.perm = b.perm;  // disjoint ranges: no sharing hazard
        local_roots[k] = lb.build(pns[tasks[k]].a, pns[tasks[k]].c);
      }
    });
  }
  for (auto &th : pool) th.join();

  // phase 3: merge arenas into b.nodes with child-id fixup
  std::vector<int64_t> task_root_global(pns.size(), -1);
  for (size_t k = 0; k < tasks.size(); k++) {
    int64_t base = (int64_t)b.nodes.size();
    for (const Node &nd : arenas[k].nodes)
      b.nodes.push_back(nd.leaf ? nd : Node{nd.box, false, nd.a + base, nd.b + base});
    task_root_global[tasks[k]] = base + local_roots[k];
  }
  // emit the phase-1 top nodes (iterative post-order over the PN tree)
  std::vector<int64_t> pn_global(pns.size(), -1);
  std::vector<std::pair<size_t, bool>> stack{{0, false}};
  while (!stack.empty()) {
    auto [id, expanded] = stack.back();
    stack.pop_back();
    const PN &p = pns[id];
    if (p.kind == 2) {
      pn_global[id] = task_root_global[id];
    } else if (p.kind == 1) {
      b.nodes.push_back({p.box, true, p.a, p.c});
      pn_global[id] = (int64_t)b.nodes.size() - 1;
    } else if (!expanded) {
      stack.push_back({id, true});
      stack.push_back({(size_t)p.a, false});
      stack.push_back({(size_t)p.c, false});
    } else {
      b.nodes.push_back({p.box, false, pn_global[(size_t)p.a], pn_global[(size_t)p.c]});
      pn_global[id] = (int64_t)b.nodes.size() - 1;
    }
  }
  return pn_global[0];
}

struct FlatWriter {
  // SoA flat records matching scene/bvh.py flatten()
  std::vector<float> c0_min, c0_max, c1_min, c1_max;
  std::vector<int32_t> c0_idx, c0_count, c1_idx, c1_count;
  const std::vector<Node> *nodes;

  int64_t emit_placeholder() {
    for (auto *v : {&c0_min, &c0_max, &c1_min, &c1_max})
      v->insert(v->end(), {0, 0, 0});
    c0_idx.push_back(0);
    c0_count.push_back(0);
    c1_idx.push_back(0);
    c1_count.push_back(0);
    return (int64_t)c0_idx.size() - 1;
  }

  void set_box(std::vector<float> &arr, int64_t slot, const float *v) {
    for (int i = 0; i < 3; i++) arr[slot * 3 + i] = v[i];
  }

  void fill(int64_t slot, const Node &node) {
    const Node &left = (*nodes)[node.a];
    const Node &right = (*nodes)[node.b];
    set_box(c0_min, slot, left.box.mn);
    set_box(c0_max, slot, left.box.mx);
    set_box(c1_min, slot, right.box.mn);
    set_box(c1_max, slot, right.box.mx);
    if (left.leaf) {
      c0_idx[slot] = (int32_t)left.a;
      c0_count[slot] = (int32_t)left.b;
    } else {
      int64_t child = emit_placeholder();
      c0_idx[slot] = (int32_t)child;
      c0_count[slot] = 0;
      fill(child, left);
    }
    if (right.leaf) {
      c1_idx[slot] = (int32_t)right.a;
      c1_count[slot] = (int32_t)right.b;
    } else {
      int64_t child = emit_placeholder();
      c1_idx[slot] = (int32_t)child;
      c1_count[slot] = 0;
      fill(child, right);
    }
  }
};

int64_t depth_of(const std::vector<Node> &nodes, int64_t root) {
  std::vector<std::pair<int64_t, int64_t>> stack{{root, 0}};
  int64_t depth = 0;
  while (!stack.empty()) {
    auto [i, d] = stack.back();
    stack.pop_back();
    depth = std::max(depth, d);
    if (!nodes[(size_t)i].leaf) {
      stack.push_back({nodes[(size_t)i].a, d + 1});
      stack.push_back({nodes[(size_t)i].b, d + 1});
    }
  }
  return depth;
}

}  // namespace

// Build + flatten a binned-SAH BVH. Inputs: bbmin/bbmax [n*3]. Outputs
// (malloc'd, caller pt_free's): perm [n] int64, and the 8 flat arrays
// ([m*3] float / [m] int32). Returns m (node count), or -1 on error.
// *out_depth receives the tree depth for traversal stack sizing.
int64_t bvh_build(const float *bbmin, const float *bbmax, int64_t n, int64_t max_leaf,
                  int64_t **out_perm, float **c0_min, float **c0_max, float **c1_min,
                  float **c1_max, int32_t **c0_idx, int32_t **c0_count, int32_t **c1_idx,
                  int32_t **c1_count, int64_t *out_depth) {
  if (n <= 0) return -1;
  std::vector<int64_t> perm_store((size_t)n);
  std::iota(perm_store.begin(), perm_store.end(), 0);
  Builder b;
  b.bbmin = bbmin;
  b.bbmax = bbmax;
  b.max_leaf = max_leaf;
  b.perm = perm_store.data();
  b.nodes.reserve((size_t)(2 * n));
  int64_t root = build_toplevel(b, n);
  *out_depth = depth_of(b.nodes, root);

  FlatWriter w;
  w.nodes = &b.nodes;
  int64_t slot0 = w.emit_placeholder();
  const Node &rn = b.nodes[(size_t)root];
  if (rn.leaf) {
    w.set_box(w.c0_min, slot0, rn.box.mn);
    w.set_box(w.c0_max, slot0, rn.box.mx);
    // finite no-child sentinel: inf would poison one-hot matmul gathers
    // (0 * inf = NaN); matches NO_CHILD_BOUND in scene/bvh.py
    float inf[3] = {3.0e37f, 3.0e37f, 3.0e37f};
    float ninf[3] = {-3.0e37f, -3.0e37f, -3.0e37f};
    w.set_box(w.c1_min, slot0, inf);
    w.set_box(w.c1_max, slot0, ninf);
    w.c0_idx[slot0] = (int32_t)rn.a;
    w.c0_count[slot0] = (int32_t)rn.b;
    w.c1_idx[slot0] = 0;
    w.c1_count[slot0] = -1;
  } else {
    w.fill(slot0, rn);
  }

  int64_t m = (int64_t)w.c0_idx.size();
  auto copy_f = [](const std::vector<float> &v) {
    float *p = (float *)std::malloc(v.size() * sizeof(float));
    std::memcpy(p, v.data(), v.size() * sizeof(float));
    return p;
  };
  auto copy_i = [](const std::vector<int32_t> &v) {
    int32_t *p = (int32_t *)std::malloc(v.size() * sizeof(int32_t));
    std::memcpy(p, v.data(), v.size() * sizeof(int32_t));
    return p;
  };
  *out_perm = (int64_t *)std::malloc((size_t)n * sizeof(int64_t));
  std::memcpy(*out_perm, perm_store.data(), (size_t)n * sizeof(int64_t));
  *c0_min = copy_f(w.c0_min);
  *c0_max = copy_f(w.c0_max);
  *c1_min = copy_f(w.c1_min);
  *c1_max = copy_f(w.c1_max);
  *c0_idx = copy_i(w.c0_idx);
  *c0_count = copy_i(w.c0_count);
  *c1_idx = copy_i(w.c1_idx);
  *c1_count = copy_i(w.c1_count);
  return m;
}

// Spatial chunk partition: split until span <= chunk with the same binned
// equal-count SAH splitter, NO leaf collapse — the native twin of
// scene/bvh.py::chunk_partition_py (cross-checked bit-identical in
// tests/test_torch_native.py). Leaves emit in left-first DFS order. Outputs
// (malloc'd): perm [n] int64, starts/spans [k] int64. Returns k or -1.
int64_t chunk_build(const float *bbmin, const float *bbmax, int64_t n,
                    int64_t chunk, int64_t **out_perm, int64_t **out_starts,
                    int64_t **out_spans) {
  if (n <= 0 || chunk <= 0) return -1;
  std::vector<int64_t> perm((size_t)n);
  std::iota(perm.begin(), perm.end(), 0);
  auto prim_box = [&](int64_t id) {
    Box b;
    for (int i = 0; i < 3; i++) {
      b.mn[i] = bbmin[id * 3 + i];
      b.mx[i] = bbmax[id * 3 + i];
    }
    return b;
  };

  // One split step on perm[start,end): first-max axis (np.argmax semantics),
  // stable sort, binned equal-count SAH (double from f32 areas — NEP-50
  // promotion parity with the NumPy splitter; strict < keeps the FIRST
  // minimum, np.argmin). Depends only on its own range, so the serial DFS
  // and the parallel frontier make identical decisions. suf_sa is caller
  // scratch (one per thread).
  auto split_once = [&](int64_t start, int64_t end, std::vector<float> &suf_sa) {
    int64_t span = end - start;
    Box nb;
    nb.reset();
    for (int64_t i = start; i < end; i++) nb.grow(prim_box(perm[(size_t)i]));
    int axis = 0;
    float best_len = nb.mx[0] - nb.mn[0];
    for (int i = 1; i < 3; i++) {
      float len = nb.mx[i] - nb.mn[i];
      if (len > best_len) {
        best_len = len;
        axis = i;
      }
    }
    std::stable_sort(perm.begin() + start, perm.begin() + end,
                     [&](int64_t a, int64_t b) {
                       return bbmin[a * 3 + axis] < bbmin[b * 3 + axis];
                     });
    int64_t bin_size = std::max<int64_t>(span / kDesiredBins, 1);
    int64_t num_bins = span / bin_size - 1;
    if (num_bins <= 0) return std::max<int64_t>(span / 2, 1);
    suf_sa.resize((size_t)span);
    Box acc;
    acc.reset();
    for (int64_t i = span - 1; i >= 0; i--) {
      acc.grow(prim_box(perm[(size_t)(start + i)]));
      suf_sa[(size_t)i] = acc.sa();
    }
    double best = INFINITY;
    int64_t best_split = -1;
    Box pre;
    pre.reset();
    int64_t next = bin_size, used = 0;
    for (int64_t j = 1; j < span && used < num_bins; j++) {
      pre.grow(prim_box(perm[(size_t)(start + j - 1)]));
      if (j == next) {
        double sah = (double)j * (double)pre.sa() +
                     (double)(span - j) * (double)suf_sa[(size_t)j];
        if (sah < best) {
          best = sah;
          best_split = j;
        }
        used++;
        next += bin_size;
      }
    }
    if (best_split < 0) best_split = std::max<int64_t>(span / 2, 1);
    return best_split;
  };

  // Serial DFS over one range (left pushed last -> leaves in left-first
  // order). Because leaf ranges are contiguous intervals partitioning the
  // range, left-first DFS order == ascending start order — which is what
  // lets independent subtree results concatenate by start below.
  auto dfs = [&](int64_t start0, int64_t end0, std::vector<int64_t> &starts,
                 std::vector<int64_t> &spans, std::vector<float> &suf_sa) {
    std::vector<std::pair<int64_t, int64_t>> stack{{start0, end0}};
    while (!stack.empty()) {
      auto [start, end] = stack.back();
      stack.pop_back();
      int64_t span = end - start;
      if (span <= chunk) {
        starts.push_back(start);
        spans.push_back(span);
        continue;
      }
      int64_t best_split = split_once(start, end, suf_sa);
      stack.push_back({start + best_split, end});  // right (popped second)
      stack.push_back({start, start + best_split});  // left (popped first)
    }
  };

  std::vector<int64_t> starts, spans;
  int nthreads = num_threads();
  if (nthreads <= 1 || n < parallel_min()) {
    std::vector<float> suf_sa;
    dfs(0, n, starts, spans, suf_sa);
  } else {
    // phase 1: serial frontier, splitting the largest range first
    std::vector<std::pair<int64_t, int64_t>> tasks{{0, n}};
    std::vector<float> suf_sa;
    size_t target = (size_t)nthreads * 4;
    while (tasks.size() < target) {
      size_t pick = tasks.size();
      int64_t best_span = -1;
      for (size_t i = 0; i < tasks.size(); i++) {
        int64_t span = tasks[i].second - tasks[i].first;
        if (span > best_span && span > chunk && span >= parallel_min()) {
          best_span = span;
          pick = i;
        }
      }
      if (pick == tasks.size()) break;  // nothing left worth splitting
      auto [start, end] = tasks[pick];
      tasks[pick] = tasks.back();
      tasks.pop_back();
      int64_t best_split = split_once(start, end, suf_sa);
      tasks.push_back({start, start + best_split});
      tasks.push_back({start + best_split, end});
    }
    // phase 2: each task range runs the serial DFS in parallel
    std::vector<std::vector<int64_t>> t_starts(tasks.size()), t_spans(tasks.size());
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; t++) {
      pool.emplace_back([&, t]() {
        std::vector<float> scratch;
        for (size_t k = (size_t)t; k < tasks.size(); k += (size_t)nthreads)
          dfs(tasks[k].first, tasks[k].second, t_starts[k], t_spans[k], scratch);
      });
    }
    for (auto &th : pool) th.join();
    // phase 3: concatenate segments in ascending start order (== DFS order)
    std::vector<size_t> order(tasks.size());
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(),
              [&](size_t a, size_t b) { return tasks[a].first < tasks[b].first; });
    for (size_t k : order) {
      starts.insert(starts.end(), t_starts[k].begin(), t_starts[k].end());
      spans.insert(spans.end(), t_spans[k].begin(), t_spans[k].end());
    }
  }
  int64_t k = (int64_t)starts.size();
  *out_perm = (int64_t *)std::malloc((size_t)n * sizeof(int64_t));
  std::memcpy(*out_perm, perm.data(), (size_t)n * sizeof(int64_t));
  *out_starts = (int64_t *)std::malloc((size_t)k * sizeof(int64_t));
  std::memcpy(*out_starts, starts.data(), (size_t)k * sizeof(int64_t));
  *out_spans = (int64_t *)std::malloc((size_t)k * sizeof(int64_t));
  std::memcpy(*out_spans, spans.data(), (size_t)k * sizeof(int64_t));
  return k;
}

// ------------------------------------------------------ JPEG entropy coder
//
// The Huffman decode of one scan into int16 coefficient blocks (natural
// order) and the Huffman encode of quantized blocks: the loops of
// path_tracer_tpu_torch/utils/imageio.py's _decode_scan_py and
// _encode_scan_py (libjpeg's jdhuff.c, jdphuff.c and jchuff.c), with the
// same output; tests/test_torch_images.py holds them to each other. A
// Python loop takes minutes on a 2048x4096 sky.

static const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};  // guards, as jdhuff.c

struct BitReader {
  const uint8_t *d;
  int64_t pos;  // in bits
  // the 32 bits from pos on, left-aligned (pos & 7 bits of the window dropped)
  inline uint32_t window() const {
    const uint8_t *p = d + (pos >> 3);
    uint32_t w = (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
    return w << (pos & 7);
  }
  inline uint32_t get(int n) {  // 1 <= n <= 16
    uint32_t v = window() >> (32 - n);
    pos += n;
    return v;
  }
  // the next Huffman symbol through a 16-bit lookahead table, or -1
  inline int symbol(const uint16_t *lut) {
    uint16_t e = lut[window() >> 16];
    if (!e) return -1;
    pos += e >> 8;
    return e & 255;
  }
};

static inline int extend(uint32_t x, int s) {
  return x < (1u << (s - 1)) ? (int)x - ((1 << s) - 1) : (int)x;
}

// One scan. data: the scan's bytes without stuffing, restart interval i at
// [starts[i], starts[i + 1]), followed by >= 1024 zero bytes. Per scan
// component c: coefs[c] int16 [rows, cols[c], 64], hs/vs its blocks per MCU,
// its lookahead tables. Returns 0, -1 (bad code), -2 (a block read past its
// interval) or -3 (the intervals do not match the restart interval).
int64_t jpeg_decode_scan(const uint8_t *data, const int64_t *starts, int64_t n_starts,
                         int64_t n_comps, int16_t *const *coefs, const int64_t *cols,
                         const int64_t *hs, const int64_t *vs, const uint16_t *const *dc_luts,
                         const uint16_t *const *ac_luts, int64_t mcus_x, int64_t mcus_y,
                         int64_t ss, int64_t se, int64_t ah, int64_t al, int64_t restart) {
  const int64_t n_mcu = mcus_x * mcus_y;
  const int64_t interval = restart ? restart : n_mcu;
  if (n_starts - 1 != (n_mcu + interval - 1) / interval) return -3;
  std::vector<int64_t> bc, boff;
  for (int64_t c = 0; c < n_comps; c++)
    for (int64_t y = 0; y < vs[c]; y++)
      for (int64_t x = 0; x < hs[c]; x++) {
        bc.push_back(c);
        boff.push_back((y * cols[c] + x) * 64);
      }
  const bool sequential = ss == 0 && se == 63 && ah == 0 && al == 0;
  const int p1 = 1 << al, m1 = -p1;
  std::vector<int64_t> pred((size_t)n_comps);
  for (int64_t it = 0; it + 1 < n_starts; it++) {
    BitReader br{data, starts[it] * 8};
    const int64_t end = starts[it + 1] * 8;
    std::fill(pred.begin(), pred.end(), 0);
    int64_t eobrun = 0;
    const int64_t m_end = std::min(n_mcu, (it + 1) * interval);
    for (int64_t m = it * interval; m < m_end; m++) {
      const int64_t my = m / mcus_x, mx = m % mcus_x;
      for (size_t b = 0; b < bc.size(); b++) {
        const int64_t c = bc[b];
        int16_t *blk = coefs[c] + my * vs[c] * cols[c] * 64 + mx * hs[c] * 64 + boff[b];
        const uint16_t *act = ac_luts[c];
        if (ss == 0 && ah == 0) {  // DC (sequential, or the first stage)
          int s = br.symbol(dc_luts[c]);
          if (s < 0 || s > 16) return -1;
          if (s) pred[c] += extend(br.get(s), s);
          blk[0] = (int16_t)(pred[c] * p1);
        } else if (ss == 0) {  // DC refinement
          if (br.get(1)) blk[0] = (int16_t)(blk[0] | p1);
        }
        if (sequential) {
          for (int k = 1; k < 64; k++) {
            int rs = br.symbol(act);
            if (rs < 0) return -1;
            int r = rs >> 4, s = rs & 15;
            if (s) {
              k += r;
              blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
            } else if (r != 15) {
              break;
            } else {
              k += 15;
            }
          }
        } else if (ss && !ah) {  // AC, first stage
          if (eobrun) {
            eobrun--;
            continue;
          }
          for (int k = (int)ss; k <= se; k++) {
            int rs = br.symbol(act);
            if (rs < 0) return -1;
            int r = rs >> 4, s = rs & 15;
            if (s) {
              k += r;
              blk[kNatural[k]] = (int16_t)(extend(br.get(s), s) * p1);
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = 1 << r;
              if (r) eobrun += br.get(r);
              eobrun--;
              break;
            }
          }
        } else if (ss) {  // AC refinement
          int k = (int)ss;
          if (!eobrun) {
            for (; k <= se; k++) {
              int rs = br.symbol(act);
              if (rs < 0) return -1;
              int r = rs >> 4, s = rs & 15;
              if (s) {  // a newly nonzero coefficient: its sign bit
                s = br.get(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = 1 << r;
                if (r) eobrun += br.get(r);
                break;
              }
              for (; k <= se; k++) {  // correction bits of nonzeros, r zeros skipped
                int16_t *t = blk + kNatural[k];
                if (*t) {
                  if (br.get(1) && !(*t & p1)) *t = (int16_t)(*t + (*t >= 0 ? p1 : m1));
                } else if (--r < 0) {
                  break;
                }
              }
              if (s) blk[kNatural[k]] = (int16_t)s;
            }
          }
          if (eobrun) {
            for (; k <= se; k++) {
              int16_t *t = blk + kNatural[k];
              if (*t && br.get(1) && !(*t & p1)) *t = (int16_t)(*t + (*t >= 0 ? p1 : m1));
            }
            eobrun--;
          }
        }
        if (br.pos > end) return -2;
      }
    }
  }
  return 0;
}

// The integer DCTs of libjpeg(-turbo), as imageio.py's NumPy
// _idct_islow_np and _fdct_quantize_np compute them.
static const int64_t kFix0298 = 2446, kFix0390 = 3196, kFix0541 = 4433, kFix0765 = 6270,
                     kFix0899 = 7373, kFix1175 = 9633, kFix1501 = 12299, kFix1847 = 15137,
                     kFix1961 = 16069, kFix2053 = 16819, kFix2562 = 20995, kFix3072 = 25172;

// jidctint.c's sums of one 1-D pass before the DESCALE; in[i * step]
static inline void idct_sums(const int64_t *in, int step, int64_t *o) {
  int64_t z2 = in[2 * step], z3 = in[6 * step];
  int64_t z1 = (z2 + z3) * kFix0541;
  int64_t tmp2 = z1 - z3 * kFix1847, tmp3 = z1 + z2 * kFix0765;
  int64_t tmp0 = (in[0] + in[4 * step]) * 8192, tmp1 = (in[0] - in[4 * step]) * 8192;
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = in[7 * step], t1 = in[5 * step], t2 = in[3 * step], t3 = in[1 * step];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int64_t z4 = t1 + t3, z5 = (z3 + z4) * kFix1175;
  t0 *= kFix0298;
  t1 *= kFix2053;
  t2 *= kFix3072;
  t3 *= kFix1501;
  z1 *= -kFix0899;
  z2 *= -kFix2562;
  z3 = z3 * -kFix1961 + z5;
  z4 = z4 * -kFix0390 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = tmp10 + t3;
  o[7] = tmp10 - t3;
  o[1] = tmp11 + t2;
  o[6] = tmp11 - t2;
  o[2] = tmp12 + t1;
  o[5] = tmp12 - t1;
  o[3] = tmp13 + t0;
  o[4] = tmp13 - t0;
}

static inline int64_t descale(int64_t v, int n) { return (v + ((int64_t)1 << (n - 1))) >> n; }

// Dequantize and inverse-DCT n blocks (jpeg_idct_islow): coef [n, 64] int16
// natural order, q [64] int16 -> out [n, 64] uint8 row-major.
void jpeg_idct_islow(const int16_t *coef, int64_t n, const int16_t *q, uint8_t *out) {
  uint8_t limit[1024];
  for (int v = 0; v < 1024; v++)
    limit[v] = (uint8_t)(v < 128 ? v + 128 : v < 512 ? 255 : v < 896 ? 0 : v - 896);
  for (int64_t b = 0; b < n; b++) {
    const int16_t *c = coef + b * 64;
    int64_t x[64], o[8];
    int ws[64];  // C int, as jidctint.c's workspace
    for (int i = 0; i < 64; i++) x[i] = (int64_t)((int)c[i] * (int)q[i]);
    for (int col = 0; col < 8; col++) {
      idct_sums(x + col, 8, o);
      for (int r = 0; r < 8; r++) ws[r * 8 + col] = (int)descale(o[r], 11);
    }
    uint8_t *dst = out + b * 64;
    for (int r = 0; r < 8; r++) {
      int64_t w[8];
      for (int i = 0; i < 8; i++) w[i] = ws[r * 8 + i];
      idct_sums(w, 1, o);
      for (int i = 0; i < 8; i++) dst[r * 8 + i] = limit[descale(o[i], 18) & 1023];
    }
  }
}

// jfdctint.c's sums of one 1-D pass before the DESCALE; outputs 0 and 4
// scaled by 1 << 13 so that every output takes the pass's descale
static inline void fdct_sums(const int64_t *in, int step, int64_t *o) {
  int64_t tmp0 = in[0] + in[7 * step], tmp7 = in[0] - in[7 * step];
  int64_t tmp1 = in[step] + in[6 * step], tmp6 = in[step] - in[6 * step];
  int64_t tmp2 = in[2 * step] + in[5 * step], tmp5 = in[2 * step] - in[5 * step];
  int64_t tmp3 = in[3 * step] + in[4 * step], tmp4 = in[3 * step] - in[4 * step];
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  o[0] = (tmp10 + tmp11) * 8192;
  o[4] = (tmp10 - tmp11) * 8192;
  int64_t z1 = (tmp12 + tmp13) * kFix0541;
  o[2] = z1 + tmp13 * kFix0765;
  o[6] = z1 - tmp12 * kFix1847;
  z1 = tmp4 + tmp7;
  int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  int64_t z5 = (z3 + z4) * kFix1175;
  z1 *= -kFix0899;
  z2 *= -kFix2562;
  z3 = z3 * -kFix1961 + z5;
  z4 = z4 * -kFix0390 + z5;
  o[7] = tmp4 * kFix0298 + z1 + z3;
  o[5] = tmp5 * kFix2053 + z2 + z4;
  o[3] = tmp6 * kFix3072 + z2 + z3;
  o[1] = tmp7 * kFix1501 + z1 + z4;
}

// Level-shift, forward-DCT (jpeg_fdct_islow: rows, then columns) and
// quantize n blocks: samples [n, 64] uint8 row-major -> out [n, 64] int16
// natural order; recip/corr/shift [64] are jcdctmgr.c's divisors.
void jpeg_fdct_quantize(const uint8_t *samples, int64_t n, const int64_t *recip,
                        const int64_t *corr, const int64_t *shift, int16_t *out) {
  for (int64_t b = 0; b < n; b++) {
    const uint8_t *s = samples + b * 64;
    int64_t x[64], ws[64], o[8];
    for (int i = 0; i < 64; i++) x[i] = (int64_t)s[i] - 128;
    for (int r = 0; r < 8; r++) {
      fdct_sums(x + r * 8, 1, o);
      for (int i = 0; i < 8; i++) ws[r * 8 + i] = descale(o[i], 11);
    }
    int16_t *dst = out + b * 64;
    for (int col = 0; col < 8; col++) {
      fdct_sums(ws + col, 8, o);
      for (int r = 0; r < 8; r++) {
        const int i = r * 8 + col;
        const int64_t d = descale(o[r], 15), a = d < 0 ? -d : d;
        const int64_t qv = ((a + corr[i]) * recip[i]) >> shift[i];
        dst[i] = (int16_t)(d < 0 ? -qv : qv);
      }
    }
  }
}

// Huffman-encode blocks [n, 64] int16 (natural order, scan order); sel[i]
// is block i's component: its DC predictor, its tables codes/sizes[2 sel]
// (DC) and [2 sel + 1] (AC). Writes the stuffed bytes, the last padded with
// 1-bits, to a malloc'd *out; returns their count or -1.
int64_t jpeg_encode_scan(const int16_t *blocks, const int32_t *sel, int64_t n,
                         const uint32_t *const *codes, const uint8_t *const *sizes,
                         uint8_t **out) {
  int32_t n_sel = 0;
  for (int64_t i = 0; i < n; i++) n_sel = std::max(n_sel, sel[i] + 1);
  std::vector<int64_t> pred((size_t)n_sel);
  uint8_t *buf = (uint8_t *)std::malloc((size_t)n * 512 + 16);  // 64 codes of <= 32 bits, stuffed
  if (!buf) return -1;
  int64_t len = 0;
  uint64_t acc = 0;
  int nacc = 0;
  auto emit = [&](uint32_t code, int size) {
    acc = (acc << size) | code;
    nacc += size;
    while (nacc >= 8) {
      nacc -= 8;
      uint8_t byte = (uint8_t)(acc >> nacc);
      buf[len++] = byte;
      if (byte == 0xFF) buf[len++] = 0;
    }
    acc &= (1ull << nacc) - 1;
  };
  auto nbits = [](int v) {
    unsigned a = (unsigned)(v < 0 ? -v : v);
    int b = 0;
    while (a) {
      b++;
      a >>= 1;
    }
    return b;
  };
  for (int64_t i = 0; i < n; i++) {
    const int16_t *blk = blocks + i * 64;
    const int c = sel[i];
    const uint32_t *dcc = codes[2 * c], *acc_t = codes[2 * c + 1];
    const uint8_t *dcs = sizes[2 * c], *acs = sizes[2 * c + 1];
    int t = (int)(blk[0] - pred[(size_t)c]);
    pred[(size_t)c] = blk[0];
    int nb = nbits(t);
    emit(dcc[nb], dcs[nb]);
    if (nb) emit((uint32_t)(t < 0 ? t - 1 : t) & ((1u << nb) - 1), nb);
    int r = 0;
    for (int k = 1; k < 64; k++) {
      t = blk[kNatural[k]];
      if (!t) {
        r++;
        continue;
      }
      for (; r > 15; r -= 16) emit(acc_t[0xF0], acs[0xF0]);
      nb = nbits(t);
      emit(acc_t[(r << 4) + nb], acs[(r << 4) + nb]);
      emit((uint32_t)(t < 0 ? t - 1 : t) & ((1u << nb) - 1), nb);
      r = 0;
    }
    if (r) emit(acc_t[0], acs[0]);
  }
  if (nacc) emit((1u << (8 - nacc)) - 1, 8 - nacc);
  *out = buf;
  return len;
}


// ------------------------------------------------- raster codecs of Pillow
//
// The byte loops of path_tracer_tpu_torch/utils/{tiff,gif,bmp,tga}.py:
// LZW (TIFF's and GIF's), PackBits, TGA and BMP run lengths, GIF's LZW
// encoder (Pillow's GifEncode.c) and the median-cut quantizer with its
// pixel mapping (libImaging Quant.c, method 0). Each has a Python twin in
// the module that uses it; tests/test_torch_formats.py holds them equal.
// Outputs are buffers the caller allocated.

// TIFF LZW (MSB-first codes, 9 to 12 bits, early change; libtiff's
// LZWDecode): decode `n` bytes into out[cap]. Returns the bytes written,
// -1 for a corrupt table (a code past the table, or no Clear first).
int64_t tiff_lzw_decode(const uint8_t *in, int64_t n, uint8_t *out, int64_t cap) {
  const int kClear = 256, kEoi = 257, kSize = 4096 + 1024;
  std::vector<int32_t> prefix(kSize), len(kSize);
  std::vector<uint8_t> suffix(kSize), first(kSize);
  for (int i = 0; i < 256; i++) prefix[i] = -1, len[i] = 1, suffix[i] = first[i] = (uint8_t)i;
  int nbits = 9, free_ent = 258, old = -1;
  int64_t bitpos = 0, o = 0;
  const int64_t total_bits = n * 8;
  while (o < cap && bitpos + nbits <= total_bits) {
    int code = 0;
    for (int k = 0; k < nbits; k++, bitpos++)
      code = code << 1 | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == kEoi) break;
    if (code == kClear) {
      nbits = 9, free_ent = 258, old = -2;
      continue;
    }
    if (old == -1) return -1;  // the first code is not a Clear
    if (old == -2) {           // the first code after a Clear
      if (code > kClear) return -1;
      out[o++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (code > free_ent || (code >= 258 && code < free_ent && len[code] == 0)) return -1;
    if (free_ent >= kSize) return -1;
    prefix[free_ent] = old;
    first[free_ent] = first[old];
    len[free_ent] = len[old] + 1;
    suffix[free_ent] = code < free_ent ? first[code] : first[old];
    if (++free_ent >= (1 << nbits) - 1 && nbits < 12) nbits++;
    // write the string of `code` backwards
    int64_t l = len[code], end = std::min(o + l, cap);
    int c = code;
    for (int64_t p = o + l - 1; p >= o; p--, c = prefix[c])
      if (p < end) out[p] = suffix[c];
    o = end;
    old = code;
  }
  return o;
}

// GIF LZW (LSB-first codes of min_size + 1 to 12 bits, Clear and End
// codes; Pillow's GifDecode.c): decode into out[cap]. Returns the pixels
// written, -1 for a code past the table, -2 when the data ends before an
// End code with the image unfilled.
int64_t gif_lzw_decode(const uint8_t *in, int64_t n, int64_t min_size, uint8_t *out, int64_t cap) {
  const int clear = 1 << min_size, end_code = clear + 1;
  std::vector<int32_t> prefix(4096, -1), len(4096, 0);
  std::vector<uint8_t> suffix(4096), first(4096);
  for (int i = 0; i < clear; i++) len[i] = 1, suffix[i] = first[i] = (uint8_t)i;
  int width = (int)min_size + 1, next = clear + 2, old = -1;
  int64_t bitpos = 0, o = 0;
  const int64_t total_bits = n * 8;
  while (o < cap) {
    if (bitpos + width > total_bits) return -2;
    int code = 0;
    for (int k = 0; k < width; k++, bitpos++)
      code |= ((in[bitpos >> 3] >> (bitpos & 7)) & 1) << k;
    if (code == clear) {
      width = (int)min_size + 1, next = clear + 2, old = -1;
      continue;
    }
    if (code == end_code) break;
    if (old < 0) {
      if (code > clear) return -1;
      out[o++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (code > next || (code == next && next >= 4096)) return -1;
    int c = code;
    if (next < 4096) {
      prefix[next] = old;
      first[next] = first[old];
      len[next] = len[old] + 1;
      suffix[next] = code < next ? first[code] : first[old];
      if (++next == (1 << width) && width < 12) width++;
    }
    int64_t l = len[c], stop = std::min(o + l, cap);
    for (int64_t p = o + l - 1; p >= o; p--, c = prefix[c])
      if (p < stop) out[p] = suffix[c];
    o = stop;
    old = code;
  }
  return o;
}

// GIF LZW encode of n indices at min_size bits (Pillow's GifEncode.c:
// a Clear first, a Clear and a reset when the table's next code would be
// 4096, codes LSB-first, an End code, the last byte zero-padded) into
// out[cap]. Returns the bytes written, -1 if cap is too small.
int64_t gif_lzw_encode(const uint8_t *in, int64_t n, int64_t min_size, uint8_t *out, int64_t cap) {
  const int kTable = 8192, kLimit = 4096;
  const int clear = 1 << min_size, end_code = clear + 1;
  std::vector<uint32_t> codes(kTable, 0);
  int next = end_code + 1, max_code = 2 * clear - 1, width = (int)min_size + 1;
  uint32_t acc = 0;
  int nacc = 0;
  int64_t o = 0;
  bool full = false;
  auto put = [&](int code) {
    acc |= (uint32_t)code << nacc;
    nacc += width;
    while (nacc >= 8) {
      if (o >= cap) {
        full = true;
        return;
      }
      out[o++] = (uint8_t)(acc & 255);
      acc >>= 8;
      nacc -= 8;
    }
  };
  auto reset = [&]() {
    next = end_code + 1, max_code = 2 * clear - 1, width = (int)min_size + 1;
    std::fill(codes.begin(), codes.end(), 0);
  };
  put(clear);
  if (n > 0) {
    int head = in[0];
    for (int64_t i = 1; i < n && !full; i++) {
      int tail = in[i];
      int probe = ((head ^ (tail << 6)) * 31) & (kTable - 1);
      bool found = false;
      while (codes[probe]) {
        if ((codes[probe] & 0xFFFFF) == (uint32_t)((head << 8) | tail)) {
          head = (int)(codes[probe] >> 20);
          found = true;
          break;
        }
        probe -= (tail << 2) | 1;
        if (probe < 0) probe += kTable;
      }
      if (found) continue;
      put(head);
      if (next < kLimit) {
        codes[probe] = (uint32_t)next << 20 | (uint32_t)head << 8 | (uint32_t)tail;
        if (next > max_code) {
          max_code = max_code * 2 + 1;
          width++;
        }
        next++;
      } else {
        put(clear);
        reset();
      }
      head = tail;
    }
    put(head);
  }
  put(end_code);
  if (nacc > 0 && !full) {
    if (o >= cap) return -1;
    out[o++] = (uint8_t)(acc & 255);
  }
  return full ? -1 : o;
}

// PackBits (TIFF compression 32773) into out[cap]. Returns the bytes
// written.
int64_t packbits_decode(const uint8_t *in, int64_t n, uint8_t *out, int64_t cap) {
  int64_t i = 0, o = 0;
  while (i < n && o < cap) {
    int h = (int8_t)in[i++];
    if (h >= 0) {
      int64_t k = std::min<int64_t>({(int64_t)h + 1, n - i, cap - o});
      std::memcpy(out + o, in + i, (size_t)k);
      i += h + 1, o += k;
    } else if (h != -128) {
      if (i >= n) break;
      int64_t k = std::min<int64_t>(1 - h, cap - o);
      std::memset(out + o, in[i++], (size_t)k);
      o += k;
    }
  }
  return o;
}

// TGA run-length packets (Pillow's TgaRleDecode.c) of `depth`-byte
// pixels, rows of row_bytes, into out[rows * row_bytes] in file order.
// Returns the bytes written, -1 for a run that crosses a row's end.
int64_t tga_rle_decode(const uint8_t *in, int64_t n, int64_t depth, int64_t row_bytes, int64_t rows,
                       uint8_t *out) {
  const int64_t cap = row_bytes * rows;
  int64_t i = 0, o = 0;
  while (o < cap && i < n) {
    const int64_t k = depth * ((in[i] & 0x7f) + 1);
    if (in[i] & 0x80) {
      if (i + 1 + depth > n) break;
      if (o % row_bytes + k > row_bytes) return -1;
      for (int64_t p = 0; p < k; p += depth) std::memcpy(out + o + p, in + i + 1, (size_t)depth);
      i += 1 + depth, o += k;
    } else {
      if (i + 1 + k > n) break;
      const int64_t m = std::min(k, cap - o);
      std::memcpy(out + o, in + i + 1, (size_t)m);
      i += 1 + k, o += m;
    }
  }
  return o;
}

// BMP RLE8 / RLE4 as Pillow's BmpRleDecoder reads them (its Python loop,
// byte for byte: the delta escape takes the two bytes after its own two,
// an absolute run of k RLE4 pixels reads k // 2 bytes, and the word
// alignment after it follows the file offset `base` + position). Writes at
// most cap indices, in file row order. Returns the count written, -1 when a
// delta's second pair is cut off.
int64_t bmp_rle_decode(const uint8_t *in, int64_t n, int64_t base, int64_t width, int64_t rle4,
                       uint8_t *out, int64_t cap) {
  int64_t i = 0, o = 0, x = 0;
  auto push = [&](uint8_t v) {
    if (o < cap) out[o] = v;
    o++;
  };
  while (o < cap) {
    if (i + 2 > n) break;
    int64_t num = in[i], byte = in[i + 1];
    i += 2;
    if (num) {
      if (x + num > width) num = std::max<int64_t>(0, width - x);
      for (int64_t k = 0; k < num; k++)
        push(rle4 ? (uint8_t)(k % 2 == 0 ? byte >> 4 : byte & 15) : (uint8_t)byte);
      x += num;
    } else if (byte == 0) {
      while (o % width) push(0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      if (i + 2 > n) break;
      i += 2;
      if (i + 2 > n) return -1;
      const int64_t right = in[i], up = in[i + 1];
      i += 2;
      for (int64_t k = 0; k < right + up * width && o < cap; k++) push(0);
      x = o % width;
    } else {
      const int64_t count = rle4 ? byte / 2 : byte;
      const int64_t got = std::min(count, n - i);
      for (int64_t k = 0; k < got; k++) {
        if (rle4) {
          push(in[i + k] >> 4);
          push(in[i + k] & 15);
        } else {
          push(in[i + k]);
        }
      }
      i += got;
      if (got < count) break;
      x += byte;
      if ((base + i) % 2) i++;
    }
  }
  return std::min(o, cap);
}

// --- median cut (libImaging Quant.c, method 0) ---

struct QBox {
  std::vector<int32_t> idx;  // entries (distinct scaled colours)
  uint32_t count;
  int64_t volume;
  int l, r;
};

static inline uint32_t qdist(const uint8_t *a, const uint8_t *b) {
  const int dr = a[0] - b[0], dg = a[1] - b[1], db = a[2] - b[2];
  return (uint32_t)(dr * dr + dg * dg + db * db);
}

// Quantize n RGB pixels to at most `colors` palette entries as Pillow's
// im.quantize(colors) does for an RGB image: the colours scaled down
// (>> scale) until at most 65536 remain, the median cut over them (the
// largest box by pixel count first, through Pillow's heap and its ties;
// split on the axis of the largest weighted range 77 / 150 / 29 at the
// count's median), each box's mean colour rounded, then each colour mapped
// to the nearest palette entry among those within twice the distance of its
// box's entry. Writes palette[3 * colors] and idx[n]; returns the palette's
// length.
int64_t median_cut_quantize(const uint8_t *px, int64_t n, int64_t colors, uint8_t *palette,
                            uint8_t *idx) {
  if (n <= 0) return 0;
  std::vector<uint32_t> table((size_t)1 << 24, 0);  // per 24-bit colour: count, later the entry
  std::vector<uint32_t> keys;                       // distinct colours, ascending
  for (int64_t i = 0; i < n; i++) {
    const uint32_t k = (uint32_t)px[3 * i] << 16 | (uint32_t)px[3 * i + 1] << 8 | px[3 * i + 2];
    table[k]++;
  }
  for (uint32_t k = 0; k < (1u << 24); k++)
    if (table[k]) keys.push_back(k);
  auto scaled = [](uint32_t k, int s) {
    return (((k >> 16) & 255) >> s) << 16 | (((k >> 8) & 255) >> s) << 8 | ((k & 255) >> s);
  };
  int scale = 0;
  std::vector<uint32_t> sk;
  for (;; scale++) {
    sk.clear();
    for (uint32_t k : keys) sk.push_back(scaled(k, scale));
    std::sort(sk.begin(), sk.end());
    sk.erase(std::unique(sk.begin(), sk.end()), sk.end());
    if (sk.size() <= 65536) break;
  }
  const int64_t m = (int64_t)sk.size();
  std::vector<uint32_t> ecount((size_t)m, 0);
  std::vector<uint8_t> ev((size_t)m * 3);
  for (int64_t e = 0; e < m; e++)
    for (int c = 0; c < 3; c++) ev[3 * e + c] = (uint8_t)(sk[e] >> (16 - 8 * c));
  std::vector<int32_t> entry_of(keys.size());
  for (size_t j = 0; j < keys.size(); j++) {
    const int32_t e = (int32_t)(std::lower_bound(sk.begin(), sk.end(), scaled(keys[j], scale)) - sk.begin());
    entry_of[j] = e;
    ecount[e] += table[keys[j]];
  }
  std::vector<QBox> boxes;
  boxes.push_back({std::vector<int32_t>((size_t)m), (uint32_t)n, -1, -1, -1});
  std::iota(boxes[0].idx.begin(), boxes[0].idx.end(), 0);
  auto volume = [&](QBox &b) {
    if (b.volume >= 0) return b.volume;
    if (b.idx.empty()) return b.volume = 0;
    int lo[3] = {255, 255, 255}, hi[3] = {0, 0, 0};
    for (int32_t e : b.idx)
      for (int c = 0; c < 3; c++) lo[c] = std::min<int>(lo[c], ev[3 * e + c]), hi[c] = std::max<int>(hi[c], ev[3 * e + c]);
    return b.volume = (int64_t)(hi[0] - lo[0] + 1) * (hi[1] - lo[1] + 1) * (hi[2] - lo[2] + 1);
  };
  // Quant.c's heap (QuantHeap.c): 1-based, the larger count on top
  std::vector<int> heap(1, -1);
  auto cmp = [&](int a, int b) { return (int)boxes[a].count - (int)boxes[b].count; };
  auto heap_add = [&](int v) {
    heap.push_back(-1);
    size_t k = heap.size() - 1;
    while (k != 1) {
      if (cmp(v, heap[k / 2]) <= 0) break;
      heap[k] = heap[k / 2];
      k /= 2;
    }
    heap[k] = v;
  };
  auto heap_remove = [&]() {
    if (heap.size() <= 1) return -1;
    const int r = heap[1], v = heap.back();
    heap.pop_back();
    const size_t cnt = heap.size() - 1;
    if (!cnt) return r;
    size_t k = 1;
    while (k * 2 <= cnt) {
      size_t l = k * 2;
      if (l < cnt && cmp(heap[l], heap[l + 1]) < 0) l++;
      if (cmp(v, heap[l]) > 0) break;
      heap[k] = heap[l];
      k = l;
    }
    heap[k] = v;
    return r;
  };
  heap_add(0);
  for (int64_t it = 1; it < colors; it++) {
    int b = -1;
    while ((b = heap_remove()) >= 0 && volume(boxes[b]) == 1) {}
    if (b < 0) break;
    int lo[3] = {255, 255, 255}, hi[3] = {0, 0, 0};
    for (int32_t e : boxes[b].idx)
      for (int c = 0; c < 3; c++) lo[c] = std::min<int>(lo[c], ev[3 * e + c]), hi[c] = std::max<int>(hi[c], ev[3 * e + c]);
    const int f[3] = {(hi[0] - lo[0]) * 77, (hi[1] - lo[1]) * 150, (hi[2] - lo[2]) * 29};
    int axis = 0;
    for (int i = 1; i < 3; i++)
      if (f[axis] < f[i]) axis = i;
    // the value group (descending) in which the running count passes half
    uint64_t hist[256] = {0};
    for (int32_t e : boxes[b].idx) hist[ev[3 * e + axis]] += ecount[e];
    uint64_t run = 0;
    int split = lo[axis];
    for (int v = 255; v >= 0; v--) {
      run += hist[v];
      if (hist[v] && run * 2 > boxes[b].count) {
        split = v;
        break;
      }
    }
    // left: values >= split, unless that is all of them (then > the least)
    const int cut = split > lo[axis] ? split : lo[axis] + 1;
    QBox L{{}, 0, -1, -1, -1}, R{{}, 0, -1, -1, -1};
    for (int32_t e : boxes[b].idx) {
      QBox &t = ev[3 * e + axis] >= cut ? L : R;
      t.idx.push_back(e);
      t.count += ecount[e];
    }
    boxes[b].idx.clear();
    boxes[b].idx.shrink_to_fit();
    const int li = (int)boxes.size();
    boxes[b].l = li, boxes[b].r = li + 1;
    boxes.push_back(std::move(L));
    boxes.push_back(std::move(R));
    heap_add(li);
    heap_add(li + 1);
  }
  // palette ids: the leaves left first, empty ones skipped
  std::vector<int32_t> box_of((size_t)m, -1);
  int32_t nbox = 0;
  std::vector<int> stack(1, 0);
  while (!stack.empty()) {
    const int b = stack.back();
    stack.pop_back();
    if (boxes[b].l >= 0) {
      stack.push_back(boxes[b].r);
      stack.push_back(boxes[b].l);
    } else if (!boxes[b].idx.empty()) {
      for (int32_t e : boxes[b].idx) box_of[e] = nbox;
      nbox++;
    }
  }
  std::vector<uint32_t> sum((size_t)nbox * 3, 0), cnt((size_t)nbox, 0);
  for (size_t j = 0; j < keys.size(); j++) {
    const int32_t bx = box_of[entry_of[j]];
    const uint32_t c = table[keys[j]];
    for (int ch = 0; ch < 3; ch++) sum[3 * bx + ch] += ((keys[j] >> (16 - 8 * ch)) & 255) * c;
    cnt[bx] += c;
  }
  for (int32_t bx = 0; bx < nbox; bx++)
    for (int ch = 0; ch < 3; ch++)
      palette[3 * bx + ch] = (uint8_t)(int)(.5 + (double)sum[3 * bx + ch] / (double)cnt[bx]);
  // the distance tables, each row sorted by (distance, index)
  std::vector<uint32_t> dist((size_t)nbox * nbox);
  std::vector<int32_t> order((size_t)nbox * nbox);
  for (int32_t i = 0; i < nbox; i++)
    for (int32_t j = 0; j < nbox; j++) dist[(size_t)i * nbox + j] = qdist(palette + 3 * i, palette + 3 * j);
  for (int32_t i = 0; i < nbox; i++) {
    int32_t *row = order.data() + (size_t)i * nbox;
    const uint32_t *d = dist.data() + (size_t)i * nbox;
    std::iota(row, row + nbox, 0);
    std::stable_sort(row, row + nbox, [&](int32_t a, int32_t b) { return d[a] < d[b]; });
  }
  // each distinct colour to its entry (kept in table[]), then the pixels
  for (size_t j = 0; j < keys.size(); j++) {
    const uint8_t p[3] = {(uint8_t)(keys[j] >> 16), (uint8_t)(keys[j] >> 8), (uint8_t)keys[j]};
    const int32_t bx = box_of[entry_of[j]];
    uint32_t best = qdist(palette + 3 * bx, p);
    int32_t match = bx;
    const uint32_t limit = best << 2;
    const int32_t *row = order.data() + (size_t)bx * nbox;
    const uint32_t *d = dist.data() + (size_t)bx * nbox;
    for (int32_t q = 0; q < nbox && d[row[q]] <= limit; q++) {
      const uint32_t dd = qdist(palette + 3 * row[q], p);
      if (dd < best) best = dd, match = row[q];
    }
    table[keys[j]] = (uint32_t)match;
  }
  for (int64_t i = 0; i < n; i++)
    idx[i] = (uint8_t)table[(uint32_t)px[3 * i] << 16 | (uint32_t)px[3 * i + 1] << 8 | px[3 * i + 2]];
  return nbox;
}

}  // extern "C"

// ------------------------------------------------------------------ WebP
// The byte loops of WebP's two bitstreams (path_tracer_tpu_torch/utils/
// vp8l.py and vp8.py hold their Python twins, which give the same output):
// VP8L's bit reader and decode loop; VP8's boolean decoder and
// per-macroblock decode (modes, tokens, reconstruction, loop filter); the
// boolean encoder, the macroblock encode (mode choice, quantization) and
// token coding. Each follows its twin line for line.

namespace {

// --- VP8L (RFC 9649) ---

struct LBits {
  const uint8_t *d;
  int64_t n, pos, limit;
  uint32_t peek(int k) const {
    const int64_t at = pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 4; i++) v |= (uint64_t)(at + i < n ? d[at + i] : 0) << (8 * i);
    return (uint32_t)((v >> (pos & 7)) & ((1u << k) - 1));
  }
  uint32_t read(int k) {
    const uint32_t v = peek(k);
    pos += k;
    return v;
  }
};

struct LCode {
  std::vector<uint32_t> t;  // symbol << 8 | length, by the next `bits` stream bits
  int bits = 0;
};

bool lcode_build(const int *len, int size, LCode &c) {
  int used = 0, last = -1, maxl = 0;
  for (int s = 0; s < size; s++)
    if (len[s]) used++, last = s, maxl = std::max(maxl, len[s]);
  if (used == 1) {
    c.bits = 0;
    c.t.assign(1, (uint32_t)last << 8);
    return true;
  }
  if (!used) return false;
  int64_t kraft = 0;
  for (int s = 0; s < size; s++)
    if (len[s]) kraft += (int64_t)1 << (maxl - len[s]);
  if (kraft != (int64_t)1 << maxl) return false;
  c.bits = maxl;
  c.t.assign((size_t)1 << maxl, 0);
  uint32_t code = 0;
  for (int l = 1; l <= maxl; l++) {
    for (int s = 0; s < size; s++) {
      if (len[s] != l) continue;
      uint32_t rev = 0;
      for (int i = 0; i < l; i++) rev |= ((code >> i) & 1) << (l - 1 - i);
      for (uint32_t k = rev; k < (1u << maxl); k += 1u << l) c.t[k] = (uint32_t)s << 8 | (uint32_t)l;
      code++;
    }
    code <<= 1;
  }
  return true;
}

inline int lsymbol(LBits &b, const LCode &c) {
  const uint32_t e = c.bits ? c.t[b.peek(c.bits)] : c.t[0];
  b.pos += e & 0xff;
  return (int)(e >> 8);
}

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

int lcode_read(LBits &b, int size, LCode &out) {
  std::vector<int> len((size_t)size, 0);
  if (b.read(1)) {
    const int count = (int)b.read(1) + 1;
    const int first = (int)b.read(b.read(1) ? 8 : 1);
    if (first < size) len[first] = 1;
    if (count == 2) {
      const int s = (int)b.read(8);
      if (s < size) len[s] = 1;
    }
  } else {
    int cl[19] = {0};
    const int ncl = (int)b.read(4) + 4;
    for (int i = 0; i < ncl; i++) cl[kCodeLengthOrder[i]] = (int)b.read(3);
    LCode clc;
    if (!lcode_build(cl, 19, clc)) return -1;
    int max_symbol = size;
    if (b.read(1)) {
      max_symbol = 2 + (int)b.read(2 + 2 * (int)b.read(3));
      if (max_symbol > size) return -1;
    }
    int symbol = 0, prev = 8;
    while (symbol < size) {
      if (max_symbol == 0) break;
      max_symbol--;
      const int n = lsymbol(b, clc);
      if (n < 16) {
        len[symbol++] = n;
        if (n) prev = n;
      } else {
        static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        const int repeat = (int)b.read(extra[n - 16]) + offset[n - 16];
        if (symbol + repeat > size) return -1;
        for (int k = 0; k < repeat; k++) len[symbol++] = n == 16 ? prev : 0;
      }
    }
  }
  if (b.pos > b.limit) return -5;
  return lcode_build(len.data(), size, out) ? 0 : -1;
}

inline int64_t lcopy(LBits &b, int s) {
  if (s < 4) return s + 1;
  const int extra = (s - 2) >> 1;
  return ((int64_t)(2 + (s & 1)) << extra) + b.read(extra) + 1;
}

inline int64_t lsub(int64_t size, int bits) { return (size + ((int64_t)1 << bits) - 1) >> bits; }

// DecodeImageStream; transforms are appended to `tf` as type, bits, xsize,
// count, data...; returns 0 or an error code of vp8l.ERRORS.
int limage(LBits &b, int64_t xsize, int64_t ysize, bool top, const int32_t *dmap, std::vector<uint32_t> &tf,
           std::vector<uint32_t> &px) {
  if (top) {
    int seen = 0;
    while (b.read(1)) {
      const int kind = (int)b.read(2);
      if (seen >> kind & 1) return -3;
      seen |= 1 << kind;
      std::vector<uint32_t> data;
      int bits = 0;
      const int64_t xs = xsize;
      if (kind == 0 || kind == 1) {
        bits = (int)b.read(3) + 2;
        const int rc = limage(b, lsub(xsize, bits), lsub(ysize, bits), false, dmap, tf, data);
        if (rc) return rc;
      } else if (kind == 3) {
        const int colors = (int)b.read(8) + 1;
        bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
        const int rc = limage(b, colors, 1, false, dmap, tf, data);
        if (rc) return rc;
        xsize = lsub(xsize, bits);
      }
      tf.insert(tf.end(), {(uint32_t)kind, (uint32_t)bits, (uint32_t)xs, (uint32_t)data.size()});
      tf.insert(tf.end(), data.begin(), data.end());
    }
  }
  int cache_bits = 0;
  if (b.read(1)) {
    cache_bits = (int)b.read(4);
    if (cache_bits < 1 || cache_bits > 11) return -2;
  }
  int meta_bits = 0;
  int64_t meta_w = 0;
  std::vector<uint32_t> groups_of;
  if (top && b.read(1)) {
    meta_bits = (int)b.read(3) + 2;
    meta_w = lsub(xsize, meta_bits);
    const int rc = limage(b, meta_w, lsub(ysize, meta_bits), false, dmap, tf, groups_of);
    if (rc) return rc;
    for (auto &g : groups_of) g = (g >> 8) & 0xffff;
  }
  uint32_t n_groups = 1;
  for (auto g : groups_of) n_groups = std::max(n_groups, g + 1);
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int sizes[5] = {280 + cache_size, 256, 256, 256, 40};
  std::vector<LCode> codes((size_t)n_groups * 5);
  for (size_t i = 0; i < codes.size(); i++) {
    const int rc = lcode_read(b, sizes[i % 5], codes[i]);
    if (rc) return rc;
  }
  const int64_t total = xsize * ysize;
  px.assign((size_t)total, 0);
  std::vector<uint32_t> cache((size_t)cache_size);
  const int shift = 32 - cache_bits;
  int64_t pos = 0, x = 0, y = 0;
  const LCode *g = codes.data();
  while (pos < total) {
    if (!groups_of.empty()) g = codes.data() + 5 * (size_t)groups_of[(size_t)((y >> meta_bits) * meta_w + (x >> meta_bits))];
    const int code = lsymbol(b, g[0]);
    int64_t length = 1;
    if (code < 256) {
      const uint32_t red = (uint32_t)lsymbol(b, g[1]), blue = (uint32_t)lsymbol(b, g[2]);
      const uint32_t alpha = (uint32_t)lsymbol(b, g[3]);
      px[(size_t)pos] = alpha << 24 | red << 16 | (uint32_t)code << 8 | blue;
    } else if (code < 280) {
      length = lcopy(b, code - 256);
      const int64_t dist_code = lcopy(b, lsymbol(b, g[4]));
      int64_t dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        dist = dmap[2 * (dist_code - 1)] + dmap[2 * (dist_code - 1) + 1] * xsize;
        if (dist < 1) dist = 1;
      }
      if (b.pos > b.limit) return -5;
      if (dist > pos || length > total - pos) return -4;
      for (int64_t i = pos; i < pos + length; i++) px[(size_t)i] = px[(size_t)(i - dist)];
    } else {
      px[(size_t)pos] = cache[(size_t)(code - 280)];
    }
    if (cache_size)
      for (int64_t i = pos; i < pos + length; i++) cache[(px[(size_t)i] * 0x1e35a7bdu) >> shift] = px[(size_t)i];
    pos += length;
    x += length;
    while (x >= xsize) x -= xsize, y++;
  }
  if (b.pos > b.limit) return -5;
  return 0;
}

// --- VP8 (RFC 6386) ---

const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const int kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0}, kCat5[] = {180, 157, 141, 134, 130, 0},
          kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const int *const kCat[4] = {kCat3, kCat4, kCat5, kCat6};
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU, DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT };
const int kYModesTree[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

struct BoolDec {
  const uint8_t *d = nullptr;
  int64_t n = 0, pos = 0;
  uint64_t value = 0;
  int bits = -8, eof = 0;
  uint32_t range = 254;
  void load() {
    if (pos < n) {
      value = (value << 8) | d[pos++];
      bits += 8;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    if (bits < 0) load();
    const uint32_t split = (range * (uint32_t)prob) >> 8;
    uint32_t r;
    int b;
    if ((value >> bits) > split) {
      r = range - split;
      value -= (uint64_t)(split + 1) << bits;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    range = (r << shift) - 1;
    bits -= shift;
    return b;
  }
};

inline int clip(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

int large_value(BoolDec &br, const uint8_t *p) {
  if (!br.bit(p[3])) return !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    const int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int bit1 = br.bit(p[8]);
  const int cat = 2 * bit1 + br.bit(p[9 + bit1]);
  int v = 0;
  for (const int *t = kCat[cat]; *t; t++) v = 2 * v + br.bit(*t);
  return v + 3 + (8 << cat);
}

// GetCoeffs; probs [8][3][11] of the block type
int get_coeffs(BoolDec &br, const uint8_t *probs, int ctx, int qdc, int qac, int n, int16_t *out) {
  const uint8_t *p = probs + (kBands[n] * 3 + ctx) * 11;
  while (n < 16) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      if (++n == 16) return 16;
      p = probs + kBands[n] * 33;
    }
    int v, nxt;
    if (!br.bit(p[2])) {
      v = 1, nxt = 1;
    } else {
      v = large_value(br, p), nxt = 2;
    }
    if (br.bit(0x80)) v = -v;
    out[kZigzag[n]] = (int16_t)(v * (n > 0 ? qac : qdc));
    n++;
    p = probs + (kBands[n] * 3 + nxt) * 11;
  }
  return 16;
}

void iwht(const int16_t *dc, int16_t *out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a0 = dc[i] + dc[12 + i], a1 = dc[4 + i] + dc[8 + i];
    const int a2 = dc[4 + i] - dc[8 + i], a3 = dc[i] - dc[12 + i];
    tmp[i] = a0 + a1, tmp[8 + i] = a0 - a1, tmp[4 + i] = a3 + a2, tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    const int d = tmp[4 * i] + 3;
    const int a0 = d + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = d - tmp[4 * i + 3];
    out[4 * i] = (int16_t)((a0 + a1) >> 3), out[4 * i + 1] = (int16_t)((a3 + a2) >> 3);
    out[4 * i + 2] = (int16_t)((a0 - a1) >> 3), out[4 * i + 3] = (int16_t)((a3 - a2) >> 3);
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void idct_add(const int16_t *c, uint8_t *dst, int64_t stride) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a = c[i] + c[8 + i], b = c[i] - c[8 + i];
    const int cc = mul2(c[4 + i]) - mul1(c[12 + i]), d = mul1(c[4 + i]) + mul2(c[12 + i]);
    tmp[4 * i] = a + d, tmp[4 * i + 1] = b + cc, tmp[4 * i + 2] = b - cc, tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    const int cc = mul2(tmp[4 + i]) - mul1(tmp[12 + i]), d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t *row = dst + i * stride;
    const int v[4] = {a + d, b + cc, b - cc, a - d};
    for (int k = 0; k < 4; k++) row[k] = (uint8_t)clip(row[k] + (v[k] >> 3), 0, 255);
  }
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// a 4x4 prediction from top (A..H), left (I..L) and the corner x
void pred4(int mode, const int *top, const int *left, int x, int *o) {
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = left[0], J = left[1], K = left[2], L = left[3];
  auto put = [&](int v, std::initializer_list<std::pair<int, int>> xy) {
    for (auto &p : xy) o[4 * p.second + p.first] = v;
  };
  switch (mode) {
    case B_DC: {
      const int dc = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (int i = 0; i < 16; i++) o[i] = dc;
      break;
    }
    case B_TM:
      for (int y = 0; y < 4; y++)
        for (int k = 0; k < 4; k++) o[4 * y + k] = clip(left[y] + top[k] - x, 0, 255);
      break;
    case B_VE: {
      const int v[4] = {avg3(x, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 16; i++) o[i] = v[i & 3];
      break;
    }
    case B_HE: {
      const int v[4] = {avg3(x, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int i = 0; i < 16; i++) o[i] = v[i >> 2];
      break;
    }
    case B_RD:
      put(avg3(J, K, L), {{0, 3}});
      put(avg3(I, J, K), {{1, 3}, {0, 2}});
      put(avg3(x, I, J), {{2, 3}, {1, 2}, {0, 1}});
      put(avg3(A, x, I), {{3, 3}, {2, 2}, {1, 1}, {0, 0}});
      put(avg3(B, A, x), {{3, 2}, {2, 1}, {1, 0}});
      put(avg3(C, B, A), {{3, 1}, {2, 0}});
      put(avg3(D, C, B), {{3, 0}});
      break;
    case B_LD:
      put(avg3(A, B, C), {{0, 0}});
      put(avg3(B, C, D), {{1, 0}, {0, 1}});
      put(avg3(C, D, E), {{2, 0}, {1, 1}, {0, 2}});
      put(avg3(D, E, F), {{3, 0}, {2, 1}, {1, 2}, {0, 3}});
      put(avg3(E, F, G), {{3, 1}, {2, 2}, {1, 3}});
      put(avg3(F, G, H), {{3, 2}, {2, 3}});
      put(avg3(G, H, H), {{3, 3}});
      break;
    case B_VR:
      put(avg2(x, A), {{0, 0}, {1, 2}});
      put(avg2(A, B), {{1, 0}, {2, 2}});
      put(avg2(B, C), {{2, 0}, {3, 2}});
      put(avg2(C, D), {{3, 0}});
      put(avg3(K, J, I), {{0, 3}});
      put(avg3(J, I, x), {{0, 2}});
      put(avg3(I, x, A), {{0, 1}, {1, 3}});
      put(avg3(x, A, B), {{1, 1}, {2, 3}});
      put(avg3(A, B, C), {{2, 1}, {3, 3}});
      put(avg3(B, C, D), {{3, 1}});
      break;
    case B_VL:
      put(avg2(A, B), {{0, 0}});
      put(avg2(B, C), {{1, 0}, {0, 2}});
      put(avg2(C, D), {{2, 0}, {1, 2}});
      put(avg2(D, E), {{3, 0}, {2, 2}});
      put(avg3(A, B, C), {{0, 1}});
      put(avg3(B, C, D), {{1, 1}, {0, 3}});
      put(avg3(C, D, E), {{2, 1}, {1, 3}});
      put(avg3(D, E, F), {{3, 1}, {2, 3}});
      put(avg3(E, F, G), {{3, 2}});
      put(avg3(F, G, H), {{3, 3}});
      break;
    case B_HU:
      put(avg2(I, J), {{0, 0}});
      put(avg2(J, K), {{2, 0}, {0, 1}});
      put(avg2(K, L), {{2, 1}, {0, 2}});
      put(avg3(I, J, K), {{1, 0}});
      put(avg3(J, K, L), {{3, 0}, {1, 1}});
      put(avg3(K, L, L), {{3, 1}, {1, 2}});
      put(L, {{3, 2}, {2, 2}, {0, 3}, {1, 3}, {2, 3}, {3, 3}});
      break;
    default:  // B_HD
      put(avg2(I, x), {{0, 0}, {2, 1}});
      put(avg2(J, I), {{0, 1}, {2, 2}});
      put(avg2(K, J), {{0, 2}, {2, 3}});
      put(avg2(L, K), {{0, 3}});
      put(avg3(A, B, C), {{3, 0}});
      put(avg3(x, A, B), {{2, 0}});
      put(avg3(I, x, A), {{1, 0}, {3, 1}});
      put(avg3(J, I, x), {{1, 1}, {3, 2}});
      put(avg3(K, J, I), {{1, 2}, {3, 3}});
      put(avg3(L, K, J), {{1, 3}});
  }
}

// a 16x16 or 8x8 prediction: DC, TM, V, H or an edge DC
void pred_block(int mode, const int *top, const int *left, int x, int size, int *o) {
  const int shift = size == 16 ? 4 : 3, n = size * size;
  int st = 0, sl = 0;
  for (int i = 0; i < size; i++) st += top[i], sl += left[i];
  int dc = -1;
  if (mode == B_DC) dc = (st + sl + size) >> (shift + 1);
  if (mode == DC_NOTOP) dc = (sl + size / 2) >> shift;
  if (mode == DC_NOLEFT) dc = (st + size / 2) >> shift;
  if (mode == DC_NOTOPLEFT) dc = 0x80;
  if (dc >= 0) {
    for (int i = 0; i < n; i++) o[i] = dc;
  } else if (mode == B_TM) {
    for (int y = 0; y < size; y++)
      for (int k = 0; k < size; k++) o[y * size + k] = clip(left[y] + top[k] - x, 0, 255);
  } else if (mode == B_VE) {
    for (int i = 0; i < n; i++) o[i] = top[i % size];
  } else {
    for (int i = 0; i < n; i++) o[i] = left[i / size];
  }
}

inline int edge_mode(int mode, int64_t mb_x, int64_t mb_y) {
  if (mode != B_DC) return mode;
  if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
  return mb_y == 0 ? DC_NOTOP : B_DC;
}

// the loop filter
inline void filter2(uint8_t *p, int64_t i, int64_t s) {
  const int p1 = p[i - 2 * s], p0 = p[i - s], q0 = p[i], q1 = p[i + s];
  const int a = 3 * (q0 - p0) + clip(p1 - q1, -128, 127);
  const int a1 = clip((a + 4) >> 3, -16, 15), a2 = clip((a + 3) >> 3, -16, 15);
  p[i - s] = (uint8_t)clip(p0 + a2, 0, 255), p[i] = (uint8_t)clip(q0 - a1, 0, 255);
}
inline void filter4(uint8_t *p, int64_t i, int64_t s) {
  const int p1 = p[i - 2 * s], p0 = p[i - s], q0 = p[i], q1 = p[i + s];
  const int a = 3 * (q0 - p0);
  const int a1 = clip((a + 4) >> 3, -16, 15), a2 = clip((a + 3) >> 3, -16, 15), a3 = (a1 + 1) >> 1;
  p[i - 2 * s] = (uint8_t)clip(p1 + a3, 0, 255), p[i - s] = (uint8_t)clip(p0 + a2, 0, 255);
  p[i] = (uint8_t)clip(q0 - a1, 0, 255), p[i + s] = (uint8_t)clip(q1 - a3, 0, 255);
}
inline void filter6(uint8_t *p, int64_t i, int64_t s) {
  const int p2 = p[i - 3 * s], p1 = p[i - 2 * s], p0 = p[i - s], q0 = p[i], q1 = p[i + s], q2 = p[i + 2 * s];
  const int a = clip(3 * (q0 - p0) + clip(p1 - q1, -128, 127), -128, 127);
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[i - 3 * s] = (uint8_t)clip(p2 + a3, 0, 255), p[i - 2 * s] = (uint8_t)clip(p1 + a2, 0, 255);
  p[i - s] = (uint8_t)clip(p0 + a1, 0, 255), p[i] = (uint8_t)clip(q0 - a1, 0, 255);
  p[i + s] = (uint8_t)clip(q1 - a2, 0, 255), p[i + 2 * s] = (uint8_t)clip(q2 - a3, 0, 255);
}
inline bool edge_ok(const uint8_t *p, int64_t i, int64_t s, int t) {
  return 4 * std::abs(p[i - s] - p[i]) + std::abs(p[i - 2 * s] - p[i + s]) <= t;
}
inline bool edge_ok2(const uint8_t *p, int64_t i, int64_t s, int t, int it) {
  if (!edge_ok(p, i, s, t)) return false;
  const int p3 = p[i - 4 * s], p2 = p[i - 3 * s], p1 = p[i - 2 * s], p0 = p[i - s];
  const int q0 = p[i], q1 = p[i + s], q2 = p[i + 2 * s], q3 = p[i + 3 * s];
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
void filter_loop(uint8_t *p, int64_t i, int64_t hs, int64_t vs, int size, int thresh, int ithresh, int hev,
                 bool mb_edge) {
  const int t = 2 * thresh + 1;
  for (int k = 0; k < size; k++, i += vs) {
    if (!edge_ok2(p, i, hs, t, ithresh)) continue;
    if (std::abs(p[i - 2 * hs] - p[i - hs]) > hev || std::abs(p[i + hs] - p[i]) > hev)
      filter2(p, i, hs);
    else if (mb_edge)
      filter6(p, i, hs);
    else
      filter4(p, i, hs);
  }
}
void filter_simple(uint8_t *p, int64_t i, int64_t hs, int64_t vs, int thresh) {
  const int t = 2 * thresh + 1;
  for (int k = 0; k < 16; k++, i += vs)
    if (edge_ok(p, i, hs, t)) filter2(p, i, hs);
}

// --- the encoder's token coding: one walk for costs, statistics and bits ---

struct BoolEnc {
  std::vector<uint8_t> out;
  uint32_t range = 255, bottom = 0;
  int bit_count = 24;
  void carry() {
    size_t i = out.size() - 1;
    while (out[i] == 255) out[i--] = 0;
    out[i]++;
  }
  void put(int bit, int prob) {
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    if (bit) {
      bottom += split;
      range -= split;
    } else {
      range = split;
    }
    while (range < 128) {
      range <<= 1;
      if (bottom & 0x80000000u) carry();
      bottom <<= 1;
      if (!--bit_count) {
        out.push_back((uint8_t)(bottom >> 24));
        bottom &= 0xffffff;
        bit_count = 8;
      }
    }
  }
  void flush() {
    const int c = bit_count;
    uint32_t v = bottom;
    if (v & ((uint32_t)1 << (32 - c))) carry();
    v <<= c & 7;
    for (int k = 0; k < (c >> 3); k++) v <<= 8;
    for (int k = 0; k < 4; k++) {
      out.push_back((uint8_t)(v >> 24));
      v <<= 8;
    }
  }
};

// put(bit, prob): a cost (1/256 bits), a statistic (prob >= 256 is a
// position + 256), or a bit
struct Sink {
  int kind;  // 0 cost, 1 statistics, 2 bits
  int64_t cost = 0;
  const int32_t *bit_cost = nullptr;
  int64_t *stats = nullptr;
  BoolEnc *enc = nullptr;
  void put(int bit, int prob) {
    if (kind == 0)
      cost += bit ? bit_cost[256 - prob] : bit_cost[prob];
    else if (kind == 1) {
      if (prob >= 256) stats[2 * (prob - 256) + bit]++;
    } else
      enc->put(bit, prob);
  }
};

// _put_block: probs [8][3][11] of the block type; returns the nz context
int put_block(Sink &s, const int16_t *lv, int first, const int32_t *probs, int ctx) {
  int last = 15;
  while (last >= first && !lv[last]) last--;
  int n = first;
  const int32_t *p = probs + (kBands[n] * 3 + ctx) * 11;
  if (last < first) {
    s.put(0, p[0]);
    return 0;
  }
  while (n < 16) {
    s.put(1, p[0]);
    while (!lv[n]) {
      s.put(0, p[1]);
      n++;
      p = probs + kBands[n] * 33;
    }
    s.put(1, p[1]);
    const int v = std::abs((int)lv[n]);
    int nxt;
    if (v == 1) {
      s.put(0, p[2]);
      nxt = 1;
    } else {
      s.put(1, p[2]);
      if (v <= 4) {
        s.put(0, p[3]);
        if (v == 2) {
          s.put(0, p[4]);
        } else {
          s.put(1, p[4]);
          s.put(v - 3, p[5]);
        }
      } else if (v <= 10) {
        s.put(1, p[3]);
        s.put(0, p[6]);
        if (v <= 6) {
          s.put(0, p[7]);
          s.put(v - 5, 159);
        } else {
          s.put(1, p[7]);
          s.put((v - 7) >> 1, 165);
          s.put((v - 7) & 1, 145);
        }
      } else {
        s.put(1, p[3]);
        s.put(1, p[6]);
        const int cat = v < 19 ? 0 : v < 35 ? 1 : v < 67 ? 2 : 3;
        s.put(cat >> 1, p[8]);
        s.put(cat & 1, p[9 + (cat >> 1)]);
        const int extra = v - 3 - (8 << cat);
        int len = 0;
        while (kCat[cat][len]) len++;
        for (int k = 0; k < len; k++) s.put((extra >> (len - 1 - k)) & 1, kCat[cat][k]);
      }
      nxt = 2;
    }
    s.put(lv[n] < 0, 0x80);
    n++;
    if (n == 16 || n > last) {
      if (n < 16) s.put(0, probs[(kBands[n] * 3 + nxt) * 11]);
      return 1;
    }
    p = probs + (kBands[n] * 3 + nxt) * 11;
  }
  return 1;
}

// the tree decisions of an i4 mode: (node, bit) pairs
int bmode_path(int mode, int i, int *nodes, int *bits, int depth) {
  for (int bit = 0; bit < 2; bit++) {
    const int nxt = kYModesTree[i + bit];
    if (nxt <= 0 && -nxt == mode) {
      nodes[depth] = i >> 1, bits[depth] = bit;
      return depth + 1;
    }
    if (nxt > 0) {
      nodes[depth] = i >> 1, bits[depth] = bit;
      const int d = bmode_path(mode, 2 * nxt, nodes, bits, depth + 1);
      if (d) return d;
    }
  }
  return 0;
}

void put_bmode(Sink &s, int mode, const uint8_t *prob) {
  int nodes[10], bits[10];
  const int d = bmode_path(mode, 0, nodes, bits, 0);
  for (int k = 0; k < d; k++) s.put(bits[k], prob[nodes[k]]);
}

void put_ymode(Sink &s, int mode) {
  if (mode == B_DC || mode == B_VE) {
    s.put(0, 156);
    s.put(mode == B_VE, 163);
  } else {
    s.put(1, 156);
    s.put(mode == B_TM, 128);
  }
}

void put_uvmode(Sink &s, int mode) {
  s.put(mode != B_DC, 142);
  if (mode == B_DC) return;
  s.put(mode != B_VE, 114);
  if (mode == B_VE) return;
  s.put(mode == B_TM, 183);
}

// the encoder's transforms and quantizer
void fdct(const int *src, const int *pred, int *out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int d0 = src[4 * i] - pred[4 * i], d1 = src[4 * i + 1] - pred[4 * i + 1];
    const int d2 = src[4 * i + 2] - pred[4 * i + 2], d3 = src[4 * i + 3] - pred[4 * i + 3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[4 * i] = (a0 + a1) * 8;
    tmp[4 * i + 1] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[4 * i + 2] = (a0 - a1) * 8;
    tmp[4 * i + 3] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; i++) {
    const int a0 = tmp[i] + tmp[12 + i], a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i], a3 = tmp[i] - tmp[12 + i];
    out[i] = (a0 + a1 + 7) >> 4;
    out[4 + i] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0);
    out[8 + i] = (a0 - a1 + 7) >> 4;
    out[12 + i] = (a3 * 2217 - a2 * 5352 + 51000) >> 16;
  }
}

void fwht(const int *dc, int *out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a0 = dc[4 * i] + dc[4 * i + 2], a1 = dc[4 * i + 1] + dc[4 * i + 3];
    const int a2 = dc[4 * i + 1] - dc[4 * i + 3], a3 = dc[4 * i] - dc[4 * i + 2];
    tmp[4 * i] = a0 + a1, tmp[4 * i + 1] = a3 + a2, tmp[4 * i + 2] = a3 - a2, tmp[4 * i + 3] = a0 - a1;
  }
  for (int i = 0; i < 4; i++) {
    const int a0 = tmp[i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[i] - tmp[8 + i];
    out[i] = (a0 + a1) >> 1, out[4 + i] = (a3 + a2) >> 1, out[8 + i] = (a3 - a2) >> 1, out[12 + i] = (a0 - a1) >> 1;
  }
}

// levels (zigzag order) from `first` and the dequantized coefficients (raster order)
void quantize(const int *coef, int first, int qdc, int qac, int rdc, int rac, int16_t *lv, int16_t *deq) {
  for (int k = 0; k < 16; k++) lv[k] = 0, deq[k] = 0;
  for (int n = first; n < 16; n++) {
    const int j = kZigzag[n], q = n == 0 ? qdc : qac, rnd = n == 0 ? rdc : rac;
    const int v = coef[j];
    const int l = std::min((std::abs(v) + ((q * rnd) >> 7)) / q, 2047);
    if (l) {
      lv[n] = (int16_t)(v > 0 ? l : -l);
      deq[j] = (int16_t)(lv[n] * q);
    }
  }
}

void recon4(const int *pred, const int16_t *deq, int *out) {
  uint8_t b[16];
  for (int i = 0; i < 16; i++) b[i] = (uint8_t)pred[i];
  idct_add(deq, b, 4);
  for (int i = 0; i < 16; i++) out[i] = b[i];
}

int64_t sse16(const int *a, const int *b) {
  int64_t s = 0;
  for (int i = 0; i < 16; i++) s += (int64_t)(a[i] - b[i]) * (a[i] - b[i]);
  return s;
}

bool any_nonzero(const int16_t *lv, int from) {
  for (int k = from; k < 16; k++)
    if (lv[k]) return true;
  return false;
}

}  // namespace

extern "C" {

// VP8L: decode the entropy-coded image at bit `bit_pos` of `data` (a VP8L
// chunk after its header, or an ALPH stream). Writes the transforms (type,
// bits, xsize, count, data...) after their count, then the residual
// pixels, into `out` (at most `cap` words). Returns the words written or an
// error code of vp8l.ERRORS (-6: `out` too small).
int64_t vp8l_decode(const uint8_t *data, int64_t n, int64_t xsize, int64_t ysize, int64_t bit_pos,
                    const int32_t *dmap, uint32_t *out, int64_t cap) {
  LBits b{data, n, bit_pos, std::max<int64_t>(8 * n, 64)};
  std::vector<uint32_t> tf, px;
  const int rc = limage(b, xsize, ysize, true, dmap, tf, px);
  if (rc) return rc;
  int64_t count = 0;
  for (size_t i = 0; i < tf.size(); i += 4 + tf[i + 3]) count++;
  const int64_t words = 1 + (int64_t)tf.size() + (int64_t)px.size();
  if (words > cap) return -6;
  out[0] = (uint32_t)count;
  std::copy(tf.begin(), tf.end(), out + 1);
  std::copy(px.begin(), px.end(), out + 1 + tf.size());
  return words;
}

// VP8: the macroblocks of a key frame after its header (vp8._decode_frame_py).
// part0 / n0 the first partition and `state` its reader's (pos, value, bits,
// range, eof) after the header; the token partitions are `parts` split at
// `offsets` [n_parts + 1]. params: update_map, 3 segment probabilities,
// use_skip, skip_p, filter type, quant [4][6], filter strengths [4][2][3].
// Writes the macroblock-aligned planes Y [16 mb_h][16 mb_w], U, V
// [8 mb_h][8 mb_w]. Returns 0, or -1 when a partition ended early.
int64_t vp8_decode_frame(const uint8_t *part0, int64_t n0, const int64_t *state, const uint8_t *parts,
                         const int64_t *offsets, int64_t n_parts, int64_t mb_w, int64_t mb_h, const int32_t *params,
                         const uint8_t *probs, const uint8_t *bmodes, uint8_t *Yo, uint8_t *Uo, uint8_t *Vo) {
  BoolDec br;
  br.d = part0, br.n = n0, br.pos = state[0], br.value = (uint64_t)state[1], br.bits = (int)state[2];
  br.range = (uint32_t)state[3], br.eof = (int)state[4];
  std::vector<BoolDec> tb((size_t)n_parts);
  for (int64_t p = 0; p < n_parts; p++) {
    tb[p].d = parts + offsets[p], tb[p].n = offsets[p + 1] - offsets[p];
    tb[p].load();
  }
  const int update_map = params[0], use_skip = params[4], skip_p = params[5], filter_type = params[6];
  const int *sp = params + 1, *quant = params + 7, *fstr = params + 31;
  const int64_t w = 16 * mb_w, h = 16 * mb_h, sy = w + 5, suv = w / 2 + 1;
  std::vector<uint8_t> Y((size_t)(sy * (h + 1)), 127), U((size_t)(suv * (h / 2 + 1)), 127), V;
  for (int64_t r = 1; r <= h; r++) Y[(size_t)(r * sy)] = 129;
  for (int64_t r = 1; r <= h / 2; r++) U[(size_t)(r * suv)] = 129;
  V = U;
  std::vector<int> top_ctx((size_t)(4 * mb_w), B_DC);
  std::vector<std::array<int, 2>> nz((size_t)mb_w, {0, 0});
  std::vector<std::array<int, 4>> finfo((size_t)(mb_w * mb_h));
  struct MB {
    int segment, skip, is_i4, modes[16], uv;
  };
  std::vector<MB> row((size_t)mb_w);
  alignas(16) int16_t c[384];
  for (int64_t mb_y = 0; mb_y < mb_h; mb_y++) {
    int left_ctx[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int64_t mb_x = 0; mb_x < mb_w; mb_x++) {
      MB &mb = row[(size_t)mb_x];
      int *top = &top_ctx[(size_t)(4 * mb_x)];
      mb.segment = update_map ? (!br.bit(sp[0]) ? br.bit(sp[1]) : br.bit(sp[2]) + 2) : 0;
      mb.skip = use_skip ? br.bit(skip_p) : 0;
      mb.is_i4 = !br.bit(145);
      if (!mb.is_i4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE) : (br.bit(163) ? B_VE : B_DC);
        mb.modes[0] = ymode;
        for (int k = 0; k < 4; k++) top[k] = left_ctx[k] = ymode;
      } else {
        for (int y = 0; y < 4; y++) {
          int ymode = left_ctx[y];
          for (int x = 0; x < 4; x++) {
            const uint8_t *prob = bmodes + (top[x] * 10 + ymode) * 9;
            int i = kYModesTree[br.bit(prob[0])];
            while (i > 0) i = kYModesTree[2 * i + br.bit(prob[i])];
            ymode = -i;
            top[x] = ymode;
          }
          for (int x = 0; x < 4; x++) mb.modes[4 * y + x] = top[x];
          left_ctx[y] = ymode;
        }
      }
      mb.uv = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE : br.bit(183) ? B_TM : B_HE;
    }
    BoolDec &tk = tb[(size_t)(mb_y % n_parts)];
    int left[2] = {0, 0};
    for (int64_t mb_x = 0; mb_x < mb_w; mb_x++) {
      const MB &mb = row[(size_t)mb_x];
      const int *q = quant + 6 * mb.segment;
      std::memset(c, 0, sizeof(c));
      bool non_zero = false;
      auto &top = nz[(size_t)mb_x];
      if (mb.skip && use_skip) {
        top[0] = left[0] = 0;
        if (!mb.is_i4) top[1] = left[1] = 0;
      } else {
        const uint8_t *ac;
        int first;
        if (!mb.is_i4) {
          int16_t dc[16] = {0}, dcs[16];
          const int n = get_coeffs(tk, probs + 1 * 264, top[1] + left[1], q[2], q[3], 0, dc);
          top[1] = left[1] = n > 0;
          iwht(dc, dcs);
          for (int i = 0; i < 16; i++) c[16 * i] = dcs[i];
          first = 1, ac = probs;
        } else {
          first = 0, ac = probs + 3 * 264;
        }
        int tnz = top[0] & 0x0f, lnz = left[0] & 0x0f;
        for (int y = 0; y < 4; y++) {
          int lbit = lnz & 1;
          for (int x = 0; x < 4; x++) {
            int16_t *blk = c + 16 * (4 * y + x);
            const int n = get_coeffs(tk, ac, lbit + (tnz & 1), q[0], q[1], first, blk);
            lbit = n > first;
            tnz = (tnz >> 1) | (lbit << 7);
            non_zero |= n > 1 || blk[0] != 0;
          }
          tnz >>= 4;
          lnz = (lnz >> 1) | (lbit << 7);
        }
        int out_t = tnz, out_l = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          tnz = top[0] >> (4 + ch), lnz = left[0] >> (4 + ch);
          for (int y = 0; y < 2; y++) {
            int lbit = lnz & 1;
            for (int x = 0; x < 2; x++) {
              int16_t *blk = c + 16 * (16 + 2 * ch + 2 * y + x);
              const int n = get_coeffs(tk, probs + 2 * 264, lbit + (tnz & 1), q[4], q[5], 0, blk);
              lbit = n > 0;
              tnz = (tnz >> 1) | (lbit << 3);
              non_zero |= n > 1 || blk[0] != 0;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (lbit << 5);
          }
          out_t |= (tnz << 4) << ch;
          out_l |= (lnz & 0xf0) << ch;
        }
        top[0] = out_t, left[0] = out_l;
      }
      const int *f = fstr + 6 * mb.segment + 3 * mb.is_i4;
      finfo[(size_t)(mb_y * mb_w + mb_x)] = {f[0], f[1], f[2], (int)(mb.is_i4 || non_zero)};
      // reconstruction into the bordered planes
      const int64_t x0 = 16 * mb_x + 1, y0 = 16 * mb_y + 1;
      int pred[256], tp[16], lf[16];
      if (mb.is_i4) {
        const uint8_t *tr = &Y[(size_t)((y0 - 1) * sy + x0 + 16)];
        for (int n = 0; n < 16; n++) {
          const int bx = n & 3, by = n >> 2;
          uint8_t *at = &Y[(size_t)((y0 + 4 * by) * sy + x0 + 4 * bx)];
          int t8[8], l4[4];
          for (int k = 0; k < 4; k++) t8[k] = at[k - sy], l4[k] = at[k * sy - 1];
          for (int k = 0; k < 4; k++) t8[4 + k] = bx == 3 ? tr[k] : at[4 + k - sy];
          pred4(mb.modes[n], t8, l4, at[-sy - 1], pred);
          for (int k = 0; k < 16; k++) at[(k >> 2) * sy + (k & 3)] = (uint8_t)pred[k];
          idct_add(c + 16 * n, at, sy);
        }
      } else {
        uint8_t *at = &Y[(size_t)(y0 * sy + x0)];
        for (int k = 0; k < 16; k++) tp[k] = at[k - sy], lf[k] = at[k * sy - 1];
        pred_block(edge_mode(mb.modes[0], mb_x, mb_y), tp, lf, at[-sy - 1], 16, pred);
        for (int k = 0; k < 256; k++) at[(k >> 4) * sy + (k & 15)] = (uint8_t)pred[k];
        for (int n = 0; n < 16; n++) idct_add(c + 16 * n, at + 4 * (n >> 2) * sy + 4 * (n & 3), sy);
      }
      const int mode = edge_mode(mb.uv, mb_x, mb_y);
      for (int ch = 0; ch < 2; ch++) {
        std::vector<uint8_t> &P = ch ? V : U;
        uint8_t *at = &P[(size_t)((8 * mb_y + 1) * suv + 8 * mb_x + 1)];
        for (int k = 0; k < 8; k++) tp[k] = at[k - suv], lf[k] = at[k * suv - 1];
        pred_block(mode, tp, lf, at[-suv - 1], 8, pred);
        for (int k = 0; k < 64; k++) at[(k >> 3) * suv + (k & 7)] = (uint8_t)pred[k];
        for (int n = 0; n < 4; n++) idct_add(c + 16 * (16 + 4 * ch + n), at + 4 * (n >> 1) * suv + 4 * (n & 1), suv);
      }
    }
    uint8_t *last = &Y[(size_t)((16 * mb_y + 16) * sy)];
    for (int k = 1; k <= 4; k++) last[w + k] = last[w];
  }
  if (br.eof) return -1;
  for (auto &p : tb)
    if (p.eof) return -1;
  for (int64_t r = 0; r < h; r++) std::memcpy(Yo + r * w, &Y[(size_t)((r + 1) * sy + 1)], (size_t)w);
  for (int64_t r = 0; r < h / 2; r++) {
    std::memcpy(Uo + r * (w / 2), &U[(size_t)((r + 1) * suv + 1)], (size_t)(w / 2));
    std::memcpy(Vo + r * (w / 2), &V[(size_t)((r + 1) * suv + 1)], (size_t)(w / 2));
  }
  if (!filter_type) return 0;
  const int64_t uw = w / 2;
  for (int64_t mb_y = 0; mb_y < mb_h; mb_y++) {
    for (int64_t mb_x = 0; mb_x < mb_w; mb_x++) {
      const auto &fi = finfo[(size_t)(mb_y * mb_w + mb_x)];
      const int limit = fi[0], ilevel = fi[1], hev = fi[2], inner = fi[3];
      if (!limit) continue;
      const int64_t y0 = 16 * mb_y * w + 16 * mb_x, c0 = 8 * mb_y * uw + 8 * mb_x;
      if (filter_type == 1) {
        if (mb_x > 0) filter_simple(Yo, y0, 1, w, limit + 4);
        if (inner)
          for (int k = 4; k < 16; k += 4) filter_simple(Yo, y0 + k, 1, w, limit);
        if (mb_y > 0) filter_simple(Yo, y0, w, 1, limit + 4);
        if (inner)
          for (int k = 4; k < 16; k += 4) filter_simple(Yo, y0 + k * w, w, 1, limit);
        continue;
      }
      if (mb_x > 0) {
        filter_loop(Yo, y0, 1, w, 16, limit + 4, ilevel, hev, true);
        filter_loop(Uo, c0, 1, uw, 8, limit + 4, ilevel, hev, true);
        filter_loop(Vo, c0, 1, uw, 8, limit + 4, ilevel, hev, true);
      }
      if (inner) {
        for (int k = 4; k < 16; k += 4) filter_loop(Yo, y0 + k, 1, w, 16, limit, ilevel, hev, false);
        filter_loop(Uo, c0 + 4, 1, uw, 8, limit, ilevel, hev, false);
        filter_loop(Vo, c0 + 4, 1, uw, 8, limit, ilevel, hev, false);
      }
      if (mb_y > 0) {
        filter_loop(Yo, y0, w, 1, 16, limit + 4, ilevel, hev, true);
        filter_loop(Uo, c0, uw, 1, 8, limit + 4, ilevel, hev, true);
        filter_loop(Vo, c0, uw, 1, 8, limit + 4, ilevel, hev, true);
      }
      if (inner) {
        for (int k = 4; k < 16; k += 4) filter_loop(Yo, y0 + k * w, w, 1, 16, limit, ilevel, hev, false);
        filter_loop(Uo, c0 + 4 * uw, uw, 1, 8, limit, ilevel, hev, false);
        filter_loop(Vo, c0 + 4 * uw, uw, 1, 8, limit, ilevel, hev, false);
      }
    }
  }
  return 0;
}

// VP8: the macroblock encode (vp8._encode_mbs_py). Y [16 mb_h][16 mb_w], U,
// V [8 mb_h][8 mb_w]; segs [mbs]; quant [4][6]; lambdas [4]; rounding
// (dc, ac) /128; probs0 [4][8][3][11] (int32); bit_cost [257]; bmodes
// [10][10][9]. Writes modes [mbs][18] and levels [mbs][25][16].
int64_t vp8_encode_mbs(const uint8_t *Yi, const uint8_t *Ui, const uint8_t *Vi, int64_t mb_w, int64_t mb_h,
                       const int32_t *segs, const int32_t *quant, const int64_t *lambdas, int64_t rdc, int64_t rac,
                       const int32_t *probs, const int32_t *bit_cost, const uint8_t *bmodes, int32_t *modes_out,
                       int16_t *levels_out) {
  const int64_t w = 16 * mb_w, h = 16 * mb_h, sy = w + 5, suv = w / 2 + 1;
  std::vector<uint8_t> R((size_t)(sy * (h + 1)), 127), RU((size_t)(suv * (h / 2 + 1)), 127), RV;
  for (int64_t r = 1; r <= h; r++) R[(size_t)(r * sy)] = 129;
  for (int64_t r = 1; r <= h / 2; r++) RU[(size_t)(r * suv)] = 129;
  RV = RU;
  std::vector<int> top_ctx((size_t)(4 * mb_w), B_DC);
  std::vector<std::array<int, 9>> nz_top((size_t)mb_w);
  for (auto &t : nz_top) t.fill(0);
  Sink cost{0};
  cost.bit_cost = bit_cost;
  auto block_cost = [&](const int16_t *lv, int first, const int32_t *pt, int ctx) {
    cost.cost = 0;
    put_block(cost, lv, first, pt, ctx);
    return cost.cost;
  };
  for (int64_t mb_y = 0; mb_y < mb_h; mb_y++) {
    int left_ctx[4] = {B_DC, B_DC, B_DC, B_DC};
    std::array<int, 9> nz_left;
    nz_left.fill(0);
    for (int64_t mb_x = 0; mb_x < mb_w; mb_x++) {
      const int64_t mb = mb_y * mb_w + mb_x;
      const int32_t *q = quant + 6 * segs[mb];
      const int64_t lam = lambdas[segs[mb]];
      const int64_t x0 = 16 * mb_x + 1, y0 = 16 * mb_y + 1;
      int bsrc[16][16], top[16], tr[4], left[16];
      for (int n = 0; n < 16; n++)
        for (int k = 0; k < 16; k++)
          bsrc[n][k] = Yi[(16 * mb_y + 4 * (n >> 2) + (k >> 2)) * w + 16 * mb_x + 4 * (n & 3) + (k & 3)];
      for (int k = 0; k < 16; k++) top[k] = R[(size_t)((y0 - 1) * sy + x0 + k)], left[k] = R[(size_t)((y0 + k) * sy + x0 - 1)];
      for (int k = 0; k < 4; k++) tr[k] = R[(size_t)((y0 - 1) * sy + x0 + 16 + k)];
      const int corner = R[(size_t)((y0 - 1) * sy + x0 - 1)];
      // i16
      int64_t best_score = -1;
      int best_mode = 0, best_tnz[4], best_lnz[4];
      int16_t best_lv[16][16], best_y2[16];
      int best_rec[16][16];
      for (int mode : {B_DC, B_TM, B_VE, B_HE}) {
        int pred[256], bpred[16][16], coefs[16][16], dcs_in[16], y2c[16];
        pred_block(edge_mode(mode, mb_x, mb_y), top, left, corner, 16, pred);
        for (int n = 0; n < 16; n++)
          for (int k = 0; k < 16; k++) bpred[n][k] = pred[16 * (4 * (n >> 2) + (k >> 2)) + 4 * (n & 3) + (k & 3)];
        for (int n = 0; n < 16; n++) fdct(bsrc[n], bpred[n], coefs[n]), dcs_in[n] = coefs[n][0];
        fwht(dcs_in, y2c);
        int16_t y2lv[16], y2deq[16], dcs[16];
        quantize(y2c, 0, q[2], q[3], (int)rdc, (int)rac, y2lv, y2deq);
        iwht(y2deq, dcs);
        int64_t rate = bit_cost[256 - 145];
        rate += mode == B_DC || mode == B_VE ? bit_cost[156] + (mode == B_VE ? bit_cost[256 - 163] : bit_cost[163])
                                             : bit_cost[256 - 156] + (mode == B_TM ? bit_cost[256 - 128] : bit_cost[128]);
        rate += block_cost(y2lv, 0, probs + 1 * 264, nz_top[(size_t)mb_x][8] + nz_left[8]);
        int tnz[4], lnz[4];
        for (int k = 0; k < 4; k++) tnz[k] = nz_top[(size_t)mb_x][k], lnz[k] = nz_left[k];
        int16_t lv_all[16][16];
        int rec[16][16];
        int64_t sse = 0;
        for (int n = 0; n < 16; n++) {
          int16_t deq[16];
          quantize(coefs[n], 1, q[0], q[1], (int)rdc, (int)rac, lv_all[n], deq);
          deq[0] = dcs[n];
          const int bx = n & 3, by = n >> 2;
          rate += block_cost(lv_all[n], 1, probs, tnz[bx] + lnz[by]);
          tnz[bx] = lnz[by] = any_nonzero(lv_all[n], 1);
          recon4(bpred[n], deq, rec[n]);
          sse += sse16(rec[n], bsrc[n]);
        }
        const int64_t score = 256 * sse + lam * rate;
        if (best_score < 0 || score < best_score) {
          best_score = score, best_mode = mode;
          std::memcpy(best_lv, lv_all, sizeof(best_lv));
          std::memcpy(best_y2, y2lv, sizeof(best_y2));
          std::memcpy(best_rec, rec, sizeof(best_rec));
          std::memcpy(best_tnz, tnz, sizeof(tnz));
          std::memcpy(best_lnz, lnz, sizeof(lnz));
        }
      }
      // i4
      int local[17][21];
      local[0][0] = corner;
      for (int k = 0; k < 16; k++) local[0][1 + k] = top[k], local[k + 1][0] = left[k];
      for (int k = 0; k < 4; k++) local[0][17 + k] = tr[k];
      int64_t score4 = lam * bit_cost[145];
      int tctx[4], lctx[4], tnz4[4], lnz4[4], modes4[16];
      for (int k = 0; k < 4; k++)
        tctx[k] = top_ctx[(size_t)(4 * mb_x + k)], lctx[k] = left_ctx[k], tnz4[k] = nz_top[(size_t)mb_x][k], lnz4[k] = nz_left[k];
      int16_t lv4[16][16];
      int rec4[16][16];
      for (int n = 0; n < 16; n++) {
        const int bx = n & 3, by = n >> 2, ax = 4 * bx + 1, ay = 4 * by + 1;
        int btop[8], bleft[4];
        for (int k = 0; k < 4; k++) {
          btop[k] = local[ay - 1][ax + k];
          btop[4 + k] = bx == 3 ? local[0][17 + k] : local[ay - 1][ax + 4 + k];
          bleft[k] = local[ay + k][ax - 1];
        }
        const int bcorner = local[ay - 1][ax - 1], ctx = tnz4[bx] + lnz4[by];
        int64_t bbest = -1;
        int bmode = 0;
        int16_t blv[16];
        int brec[16];
        for (int m = 0; m < 10; m++) {
          int pred[16], coef[16], rb[16];
          int16_t lv[16], deq[16];
          pred4(m, btop, bleft, bcorner, pred);
          fdct(bsrc[n], pred, coef);
          quantize(coef, 0, q[0], q[1], (int)rdc, (int)rac, lv, deq);
          recon4(pred, deq, rb);
          cost.cost = 0;
          put_bmode(cost, m, bmodes + (tctx[bx] * 10 + lctx[by]) * 9);
          const int64_t mode_bits = cost.cost;
          const int64_t rate = block_cost(lv, 0, probs + 3 * 264, ctx) + mode_bits;
          const int64_t s = 256 * sse16(rb, bsrc[n]) + lam * rate;
          if (bbest < 0 || s < bbest) {
            bbest = s, bmode = m;
            std::memcpy(blv, lv, sizeof(blv));
            std::memcpy(brec, rb, sizeof(brec));
          }
        }
        score4 += bbest;
        tctx[bx] = lctx[by] = bmode;
        tnz4[bx] = lnz4[by] = any_nonzero(blv, 0);
        for (int k = 0; k < 16; k++) local[ay + (k >> 2)][ax + (k & 3)] = brec[k];
        modes4[n] = bmode;
        std::memcpy(lv4[n], blv, sizeof(blv));
        std::memcpy(rec4[n], brec, sizeof(brec));
      }
      int32_t *mo = modes_out + 18 * mb;
      int16_t *lo = levels_out + 400 * mb;
      std::memset(mo, 0, 18 * sizeof(int32_t));
      std::memset(lo, 0, 400 * sizeof(int16_t));
      const int(*yrec)[16];
      if (score4 < best_score) {
        mo[0] = 1;
        for (int n = 0; n < 16; n++) mo[1 + n] = modes4[n];
        std::memcpy(lo, lv4, sizeof(lv4));
        yrec = rec4;
        for (int k = 0; k < 4; k++) top_ctx[(size_t)(4 * mb_x + k)] = tctx[k], left_ctx[k] = lctx[k];
        for (int k = 0; k < 4; k++) nz_top[(size_t)mb_x][k] = tnz4[k], nz_left[k] = lnz4[k];
      } else {
        mo[1] = best_mode;
        std::memcpy(lo, best_lv, sizeof(best_lv));
        std::memcpy(lo + 384, best_y2, sizeof(best_y2));
        yrec = best_rec;
        for (int k = 0; k < 4; k++) top_ctx[(size_t)(4 * mb_x + k)] = left_ctx[k] = best_mode;
        nz_top[(size_t)mb_x][8] = nz_left[8] = any_nonzero(best_y2, 0);
        for (int k = 0; k < 4; k++) nz_top[(size_t)mb_x][k] = best_tnz[k], nz_left[k] = best_lnz[k];
      }
      for (int n = 0; n < 16; n++)
        for (int k = 0; k < 16; k++)
          R[(size_t)((y0 + 4 * (n >> 2) + (k >> 2)) * sy + x0 + 4 * (n & 3) + (k & 3))] = (uint8_t)yrec[n][k];
      // chroma
      const int64_t cx = 8 * mb_x + 1, cy = 8 * mb_y + 1;
      int ptop[2][8], pleft[2][8], pcorner[2], csrc[2][4][16];
      for (int ch = 0; ch < 2; ch++) {
        const std::vector<uint8_t> &P = ch ? RV : RU;
        const uint8_t *S = ch ? Vi : Ui;
        for (int k = 0; k < 8; k++) ptop[ch][k] = P[(size_t)((cy - 1) * suv + cx + k)], pleft[ch][k] = P[(size_t)((cy + k) * suv + cx - 1)];
        pcorner[ch] = P[(size_t)((cy - 1) * suv + cx - 1)];
        for (int n = 0; n < 4; n++)
          for (int k = 0; k < 16; k++)
            csrc[ch][n][k] = S[(8 * mb_y + 4 * (n >> 1) + (k >> 2)) * (w / 2) + 8 * mb_x + 4 * (n & 1) + (k & 3)];
      }
      int64_t cbest = -1;
      int cmode = 0, ctn[4], cln[4];
      int16_t clv[8][16];
      int crec[8][16];
      for (int mode : {B_DC, B_TM, B_VE, B_HE}) {
        cost.cost = 0;
        put_uvmode(cost, mode);
        int64_t rate = cost.cost, sse = 0;
        int tn[4], ln[4];
        for (int k = 0; k < 4; k++) tn[k] = nz_top[(size_t)mb_x][4 + k], ln[k] = nz_left[4 + k];
        int16_t lv_all[8][16];
        int recs[8][16];
        for (int ch = 0; ch < 2; ch++) {
          int pred[64];
          pred_block(edge_mode(mode, mb_x, mb_y), ptop[ch], pleft[ch], pcorner[ch], 8, pred);
          for (int n = 0; n < 4; n++) {
            const int bx = n & 1, by = n >> 1;
            int bp[16], coef[16];
            for (int k = 0; k < 16; k++) bp[k] = pred[8 * (4 * by + (k >> 2)) + 4 * bx + (k & 3)];
            int16_t deq[16];
            int16_t *lv = lv_all[4 * ch + n];
            fdct(csrc[ch][n], bp, coef);
            quantize(coef, 0, q[4], q[5], (int)rdc, (int)rac, lv, deq);
            rate += block_cost(lv, 0, probs + 2 * 264, tn[2 * ch + bx] + ln[2 * ch + by]);
            tn[2 * ch + bx] = ln[2 * ch + by] = any_nonzero(lv, 0);
            recon4(bp, deq, recs[4 * ch + n]);
            sse += sse16(recs[4 * ch + n], csrc[ch][n]);
          }
        }
        const int64_t score = 256 * sse + lam * rate;
        if (cbest < 0 || score < cbest) {
          cbest = score, cmode = mode;
          std::memcpy(clv, lv_all, sizeof(clv));
          std::memcpy(crec, recs, sizeof(crec));
          std::memcpy(ctn, tn, sizeof(tn));
          std::memcpy(cln, ln, sizeof(ln));
        }
      }
      for (int k = 0; k < 4; k++) nz_top[(size_t)mb_x][4 + k] = ctn[k], nz_left[4 + k] = cln[k];
      for (int ch = 0; ch < 2; ch++) {
        std::vector<uint8_t> &P = ch ? RV : RU;
        for (int n = 0; n < 4; n++)
          for (int k = 0; k < 16; k++)
            P[(size_t)((cy + 4 * (n >> 1) + (k >> 2)) * suv + cx + 4 * (n & 1) + (k & 3))] = (uint8_t)crec[4 * ch + n][k];
      }
      mo[17] = cmode;
      std::memcpy(lo + 256, clv, sizeof(clv));
    }
    uint8_t *last = &R[(size_t)((16 * mb_y + 16) * sy)];
    for (int k = 1; k <= 4; k++) last[w + k] = last[w];
  }
  return 0;
}

// VP8: the token partitions (vp8._write_tokens_py): modes [mbs][18], levels
// [mbs][25][16], skips [mbs], probs [4][8][3][11] as int32 (positions + 256
// for statistics). With stats non-null only counts (zeros, ones) into
// stats [1056][2]; else writes the partitions one after another into out
// (cap bytes) and their sizes into sizes [n_parts]. Returns the bytes
// written, or -1 when out is too small.
int64_t vp8_write_tokens(const int32_t *modes, const int16_t *levels, const uint8_t *skips, const int32_t *probs,
                         int64_t mb_w, int64_t n_mb, int64_t n_parts, int64_t *stats, uint8_t *out, int64_t cap,
                         int64_t *sizes) {
  std::vector<BoolEnc> encs((size_t)n_parts);
  Sink s{stats ? 1 : 2};
  s.stats = stats;
  std::vector<std::array<int, 9>> nz_top((size_t)mb_w);
  for (auto &t : nz_top) t.fill(0);
  for (int64_t mb_y = 0; mb_y < n_mb / mb_w; mb_y++) {
    s.enc = &encs[(size_t)(mb_y % n_parts)];
    std::array<int, 9> left;
    left.fill(0);
    for (int64_t mb_x = 0; mb_x < mb_w; mb_x++) {
      const int64_t mb = mb_y * mb_w + mb_x;
      const int is_i4 = modes[18 * mb];
      auto &top = nz_top[(size_t)mb_x];
      const int16_t *lv = levels + 400 * mb;
      if (skips[mb]) {
        for (int k = 0; k < 8; k++) top[k] = left[k] = 0;
        if (!is_i4) top[8] = left[8] = 0;
        continue;
      }
      int first;
      const int32_t *ac;
      if (!is_i4) {
        top[8] = left[8] = put_block(s, lv + 384, 0, probs + 264, top[8] + left[8]);
        first = 1, ac = probs;
      } else {
        first = 0, ac = probs + 3 * 264;
      }
      for (int n = 0; n < 16; n++) {
        const int bx = n & 3, by = n >> 2;
        top[bx] = left[by] = put_block(s, lv + 16 * n, first, ac, top[bx] + left[by]);
      }
      for (int n = 0; n < 8; n++) {
        const int ch = n >> 2, bx = n & 1, by = (n >> 1) & 1;
        top[4 + 2 * ch + bx] = left[4 + 2 * ch + by] =
            put_block(s, lv + 16 * (16 + n), 0, probs + 2 * 264, top[4 + 2 * ch + bx] + left[4 + 2 * ch + by]);
      }
    }
  }
  if (stats) return 0;
  int64_t total = 0;
  for (int64_t p = 0; p < n_parts; p++) {
    encs[(size_t)p].flush();
    const int64_t n = (int64_t)encs[(size_t)p].out.size();
    if (total + n > cap) return -1;
    std::memcpy(out + total, encs[(size_t)p].out.data(), (size_t)n);
    sizes[p] = n;
    total += n;
  }
  return total;
}

// VP8: the first partition (vp8._write_modes_py): the header's decisions
// bits [n_bits][2] (bit, prob), then each macroblock's segment (seg_probs
// non-null), skip flag (skip_p > 0) and modes. Returns the bytes written,
// or -1 when out (cap bytes) is too small.
int64_t vp8_write_modes(const int32_t *bits, int64_t n_bits, const int32_t *modes, const int32_t *segs,
                        const uint8_t *skips, const int32_t *seg_probs, int64_t skip_p, int64_t mb_w, int64_t n_mb,
                        const uint8_t *bmodes, uint8_t *out, int64_t cap) {
  BoolEnc enc;
  Sink s{2};
  s.enc = &enc;
  for (int64_t i = 0; i < n_bits; i++) enc.put(bits[2 * i], bits[2 * i + 1]);
  std::vector<int> top_ctx((size_t)(4 * mb_w), B_DC);
  int left_ctx[4] = {B_DC, B_DC, B_DC, B_DC};
  for (int64_t mb = 0; mb < n_mb; mb++) {
    const int64_t mb_x = mb % mb_w;
    const int32_t *m = modes + 18 * mb;
    if (mb_x == 0)
      for (int k = 0; k < 4; k++) left_ctx[k] = B_DC;
    if (seg_probs) {
      const int sg = segs[mb];
      enc.put(sg >> 1, seg_probs[0]);
      enc.put(sg & 1, seg_probs[1 + (sg >> 1)]);
    }
    if (skip_p) enc.put(skips[mb], (int)skip_p);
    enc.put(1 - m[0], 145);
    if (m[0]) {
      for (int n = 0; n < 16; n++) {
        const int bx = n & 3, by = n >> 2;
        put_bmode(s, m[1 + n], bmodes + (top_ctx[(size_t)(4 * mb_x + bx)] * 10 + left_ctx[by]) * 9);
        top_ctx[(size_t)(4 * mb_x + bx)] = left_ctx[by] = m[1 + n];
      }
    } else {
      put_ymode(s, m[1]);
      for (int k = 0; k < 4; k++) top_ctx[(size_t)(4 * mb_x + k)] = left_ctx[k] = m[1];
    }
    put_uvmode(s, m[17]);
  }
  enc.flush();
  if ((int64_t)enc.out.size() > cap) return -1;
  std::memcpy(out, enc.out.data(), enc.out.size());
  return (int64_t)enc.out.size();
}

}  // extern "C"

// ------------------------------------------- arithmetic and lossless JPEG
//
// The scan loops of path_tracer_tpu_torch/utils/jpeg_arith.py and
// jpeg_lossless.py (libjpeg-turbo's jdarith.c; jdlhuff.c, jddiffct.c and
// jdpred.c), each with the same output as its Python twin;
// tests/test_torch_variants.py holds them to each other.

namespace {

// T.81 Annex D's decoder (jdarith.c arith_decode) over one restart
// interval's unstuffed bytes; past their end it reads zeros, as libjpeg
// does at a marker.
struct ArithDec {
  const uint8_t *d;
  int64_t pos, end;
  const int64_t *qe_tab;
  int64_t a = 0, c = 0;
  int ct = -16;
  int decode(uint8_t *st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int64_t byte = pos < end ? d[pos] : 0;
        pos++;
        c = (c << 8) | byte;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = qe_tab[sv & 0x7F];
    int nl = (int)(qe & 0xFF), nm = (int)((qe >> 8) & 0xFF);
    qe >>= 16;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// Figures F.23 / F.24 after the first category decision `m` on st: the
// magnitude v - 1, or -1 on an overflow.
inline int arith_magnitude(ArithDec &ad, uint8_t *stats, uint8_t *st, int x1, bool ac) {
  int m = ad.decode(st);
  if (m) {
    if (!ac || ad.decode(st)) {
      if (ac) m <<= 1;
      st = stats + x1;
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) return -1;
        st++;
      }
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (ad.decode(st)) v |= m;
  return v;
}

}  // namespace

extern "C" {

// One arithmetic-coded DCT scan; the arguments of jpeg_decode_scan, with
// per scan component its (DC, AC) statistics tables instead of lookahead
// tables, the DAC conditioning L, U, Kx (16 each), Table D.2 packed as
// jpeg_arith.QE and the natural order (64 entries). Returns 0 or -3.
int64_t jpeg_arith_decode_scan(const uint8_t *data, const int64_t *starts, int64_t n_starts,
                               int64_t n_comps, int16_t *const *coefs, const int64_t *cols,
                               const int64_t *hs, const int64_t *vs, const int64_t *dc_tbl,
                               const int64_t *ac_tbl, const int64_t *cond_l, const int64_t *cond_u,
                               const int64_t *cond_k, const int64_t *qe_tab, const int64_t *natural,
                               int64_t mcus_x, int64_t mcus_y, int64_t ss, int64_t se, int64_t ah,
                               int64_t al, int64_t restart) {
  const int64_t n_mcu = mcus_x * mcus_y;
  const int64_t interval = restart ? restart : n_mcu;
  if (n_starts - 1 != (n_mcu + interval - 1) / interval) return -3;
  std::vector<int64_t> bc, boff;
  for (int64_t c = 0; c < n_comps; c++)
    for (int64_t y = 0; y < vs[c]; y++)
      for (int64_t x = 0; x < hs[c]; x++) {
        bc.push_back(c);
        boff.push_back((y * cols[c] + x) * 64);
      }
  const bool progressive = !(ss == 0 && se == 63 && ah == 0 && al == 0);
  const bool dc_scan = !progressive || (ss == 0 && ah == 0);
  const bool ac_scan = !progressive || ss > 0;
  std::vector<uint8_t> dc_stats(16 * 64), ac_stats(16 * 256);
  uint8_t fixed = 113;
  const int p1 = 1 << al, m1 = -p1;
  std::vector<int64_t> pred((size_t)n_comps), ctx((size_t)n_comps);
  for (int64_t it = 0; it + 1 < n_starts; it++) {
    ArithDec ad{data, starts[it], starts[it + 1], qe_tab};
    std::fill(pred.begin(), pred.end(), 0);
    std::fill(ctx.begin(), ctx.end(), 0);
    for (int64_t c = 0; c < n_comps; c++) {
      if (dc_scan) std::fill_n(dc_stats.begin() + dc_tbl[c] * 64, 64, 0);
      if (ac_scan) std::fill_n(ac_stats.begin() + ac_tbl[c] * 256, 256, 0);
    }
    bool broken = false;
    const int64_t m_end = std::min(n_mcu, (it + 1) * interval);
    for (int64_t m = it * interval; m < m_end && !broken; m++) {
      const int64_t my = m / mcus_x, mx = m % mcus_x;
      for (size_t b = 0; b < bc.size() && !broken; b++) {
        const int64_t c = bc[b];
        int16_t *blk = coefs[c] + my * vs[c] * cols[c] * 64 + mx * hs[c] * 64 + boff[b];
        if (progressive && ss == 0 && ah) {  // DC refinement
          if (ad.decode(&fixed)) blk[0] = (int16_t)(blk[0] | p1);
          continue;
        }
        if (dc_scan) {  // Figure F.19
          uint8_t *stats = dc_stats.data() + dc_tbl[c] * 64;
          uint8_t *st = stats + ctx[c];
          int64_t d = 0;
          if (!ad.decode(st)) {
            ctx[c] = 0;
          } else {
            const int sign = ad.decode(st + 1);
            st += 2 + sign;
            int m0 = ad.decode(st);
            if (m0) {
              st = stats + 20;
              while (ad.decode(st)) {
                if ((m0 <<= 1) == 0x8000) {
                  broken = true;
                  break;
                }
                st++;
              }
              if (broken) break;
            }
            const int64_t l = dc_tbl[c];
            if (m0 < (int)((1L << cond_l[l]) >> 1))
              ctx[c] = 0;
            else if (m0 > (int)((1L << cond_u[l]) >> 1))
              ctx[c] = 12 + sign * 4;
            else
              ctx[c] = 4 + sign * 4;
            int v = m0;
            st += 14;
            while (m0 >>= 1)
              if (ad.decode(st)) v |= m0;
            v += 1;
            d = sign ? -v : v;
          }
          pred[c] = (pred[c] + d) & 0xFFFF;
          blk[0] = (int16_t)(uint16_t)(progressive ? (pred[c] << al) : pred[c]);
          if (progressive) continue;
        }
        uint8_t *stats = ac_stats.data() + ac_tbl[c] * 256;
        const int64_t kx = cond_k[ac_tbl[c]];
        if (!ah) {  // sequential, or the AC first stage (Figure F.20)
          const int64_t last = progressive ? se : 63;
          for (int64_t k = progressive ? ss : 1; k <= last; k++) {
            uint8_t *st = stats + 3 * (k - 1);
            if (ad.decode(st)) break;  // EOB
            while (!ad.decode(st + 1)) {
              st += 3;
              if (++k > last) {
                broken = true;
                break;
              }
            }
            if (broken) break;
            const int sign = ad.decode(&fixed);
            int v = arith_magnitude(ad, stats, st + 2, k <= kx ? 189 : 217, true);
            if (v < 0) {
              broken = true;
              break;
            }
            v += 1;
            blk[natural[k]] = (int16_t)(uint16_t)((uint32_t)(sign ? -v : v) << al);
          }
          continue;
        }
        // AC refinement (G.1.3.3)
        int64_t kex = se;
        while (kex > 0 && !blk[natural[kex]]) kex--;
        for (int64_t k = ss; k <= se; k++) {
          uint8_t *st = stats + 3 * (k - 1);
          if (k > kex && ad.decode(st)) break;
          for (;;) {
            int16_t *t = blk + natural[k];
            if (*t) {
              if (ad.decode(st + 2)) *t = (int16_t)(*t + (*t < 0 ? m1 : p1));
              break;
            }
            if (ad.decode(st + 1)) {
              *t = (int16_t)(ad.decode(&fixed) ? m1 : p1);
              break;
            }
            st += 3;
            if (++k > se) {
              broken = true;
              break;
            }
          }
          if (broken) break;
        }
      }
    }
  }
  return 0;
}

// One lossless scan (Huffman): the arguments of
// jpeg_lossless.decode_scan_py, per scan component its uint8 plane
// [heights[c], widths[c]], (hs, vs) samples per MCU, its lookahead table and
// its rows per iMCU row. Returns 0, -1 (bad code), -2 (data ends early),
// or -3 (restart intervals do not match).
int64_t jpeg_lossless_decode_scan(const uint8_t *data, const int64_t *starts, int64_t n_starts,
                                  int64_t n_comps, uint8_t *const *planes, const int64_t *widths,
                                  const int64_t *heights, const int64_t *hs, const int64_t *vs,
                                  const uint16_t *const *luts, const int64_t *rows_per_imcu,
                                  int64_t mcus_x, int64_t mcus_y, int64_t predictor, int64_t pt,
                                  int64_t restart) {
  const int64_t n_mcu = mcus_x * mcus_y;
  const int64_t interval = restart ? restart : n_mcu;
  if (n_starts - 1 != (n_mcu + interval - 1) / interval) return -3;
  // the differences, grown an MCU row at a time (data that ends early allocates little)
  std::vector<std::vector<int32_t>> diffs((size_t)n_comps);
  std::vector<int64_t> dw((size_t)n_comps);
  for (int64_t c = 0; c < n_comps; c++) dw[c] = mcus_x * hs[c];
  for (int64_t it = 0; it + 1 < n_starts; it++) {
    BitReader br{data, starts[it] * 8};
    const int64_t end = starts[it + 1] * 8;
    const int64_t m_end = std::min(n_mcu, (it + 1) * interval);
    for (int64_t m = it * interval; m < m_end; m++) {
      const int64_t my = m / mcus_x, mx = m % mcus_x;
      if (mx == 0)
        for (int64_t c = 0; c < n_comps; c++) diffs[c].resize((size_t)(dw[c] * (my + 1) * vs[c]), 0);
      for (int64_t c = 0; c < n_comps; c++)
        for (int64_t y = 0; y < vs[c]; y++)
          for (int64_t x = 0; x < hs[c]; x++) {
            int s = br.symbol(luts[c]);
            if (s < 0 || s > 16) return -1;
            int32_t d = 0;
            if (s == 16)
              d = 32768;
            else if (s)
              d = extend(br.get(s), s);
            diffs[c][(size_t)((my * vs[c] + y) * dw[c] + mx * hs[c] + x)] = d;
          }
      if (br.pos > end) return -2;
    }
  }
  const int64_t restart_rows = restart ? interval / mcus_x : 0;
  const int seed = 1 << (8 - pt - 1);
  for (int64_t c = 0; c < n_comps; c++) {
    const int64_t w = widths[c], h = heights[c], rpi = rows_per_imcu[c];
    std::vector<char> reset((size_t)std::max<int64_t>(h, 1), 0);
    for (int64_t k = 0; k < mcus_y; k += restart_rows ? restart_rows : mcus_y) {
      const int64_t r = (k * vs[c] / rpi) * rpi;
      if (r < h) reset[(size_t)r] = 1;
    }
    std::vector<int32_t> prev((size_t)w, 0), row((size_t)w, 0);
    for (int64_t y = 0; y < h; y++) {
      const int32_t *dr = diffs[c].data() + y * dw[c];
      if (reset[(size_t)y]) {
        int32_t ra = (dr[0] + seed) & 0xFFFF;
        row[0] = ra;
        for (int64_t x = 1; x < w; x++) row[(size_t)x] = ra = (dr[x] + ra) & 0xFFFF;
      } else {
        int32_t rb = prev[0], ra = (dr[0] + rb) & 0xFFFF, rc;
        row[0] = ra;
        for (int64_t x = 1; x < w; x++) {
          rc = rb;
          rb = prev[(size_t)x];
          int32_t p;
          switch (predictor) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = ra + rb - rc; break;
            case 5: p = ra + ((rb - rc) >> 1); break;
            case 6: p = rb + ((ra - rc) >> 1); break;
            default: p = (ra + rb) >> 1; break;
          }
          row[(size_t)x] = ra = (dr[x] + p) & 0xFFFF;
        }
      }
      uint8_t *out = planes[c] + y * w;
      for (int64_t x = 0; x < w; x++) out[x] = (uint8_t)(row[(size_t)x] << pt);
      std::swap(prev, row);
    }
  }
  return 0;
}


// CCITT rows of one TIFF strip or tile (path_tracer_tpu_torch/utils/ccitt.py
// decode_py, libtiff's tif_fax3.c): `code` the TIFF compression (2 modified
// Huffman, 3 Group 3, 4 Group 4), `options` its T4Options / T6Options; the
// caller's lookahead tables of both colours (`run << 4 | length`, -1 for
// EOL, 0 for no code; 12 and 13 bits wide). Writes rows * ceil(width / 8)
// packed bytes (a run of the second colour as 1 bits). Returns 0 or the
// negative codes of ccitt.ERRORS.
int64_t ccitt_decode(const uint8_t *data, int64_t n, int64_t width, int64_t rows, int64_t code,
                     int64_t options, const int32_t *white_lut, const int32_t *black_lut, uint8_t *out) {
  const int64_t nbits = n * 8;
  int64_t pos = 0;
  auto bit = [&](int64_t p) -> uint32_t { return p < nbits ? (data[p >> 3] >> (7 - (p & 7))) & 1 : 0; };
  auto peek = [&](int k) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) v = v << 1 | bit(pos + i);
    return v;
  };
  auto run = [&](const int32_t *lut, int k) -> int64_t {
    int64_t length = 0;
    for (;;) {
      if (pos >= nbits) return -2;
      const int32_t e = lut[peek(k)];
      if (e <= 0) return -1;
      pos += e & 15;
      length += e >> 4;
      if ((e >> 4) < 64) return length;
    }
  };
  // 2-D mode codes by (length, value): P 0001, H 001, V0 1, VR1-3 011
  // 000011 0000011, VL1-3 010 000010 0000010
  const int64_t row_bytes = (width + 7) / 8;
  std::memset(out, 0, (size_t)(rows * row_bytes));
  std::vector<int64_t> ref{width, width}, cur;
  for (int64_t r = 0; r < rows; r++) {
    bool two_d = code == 4;
    if (code == 3) {  // SYNC_EOL
      while (pos + 11 <= nbits && peek(11) != 0) pos++;
      if (pos + 11 > nbits) return -2;
      while (pos < nbits && !bit(pos)) pos++;
      if (pos >= nbits) return -2;
      pos++;
      if (options & 1) {
        if (pos >= nbits) return -2;
        two_d = !bit(pos);
        pos++;
      }
    }
    cur.clear();
    if (!two_d) {
      int64_t a0 = 0;
      int colour = 0;
      while (a0 < width) {
        const int64_t len = colour ? run(black_lut, 13) : run(white_lut, 12);
        if (len < 0) return len;
        a0 += len;
        cur.push_back(a0);
        colour ^= 1;
      }
      if (a0 != width) return -3;
      if (code == 2) pos = (pos + 7) / 8 * 8;
    } else {
      int64_t a0 = -1;
      int colour = 0;
      while (a0 < width) {
        size_t i = 0;
        while (i < ref.size() && (ref[i] <= a0 || (int)(i % 2) != colour)) i++;
        const int64_t b1 = i < ref.size() ? ref[i] : width;
        const int64_t b2 = i + 1 < ref.size() ? ref[i + 1] : width;
        if (pos >= nbits) return -2;
        int kind = -1, d = 0;  // 0 pass, 1 horizontal, 2 vertical
        if (bit(pos)) {
          kind = 2, pos += 1;
        } else if (peek(3) == 3) {
          kind = 2, d = 1, pos += 3;
        } else if (peek(3) == 2) {
          kind = 2, d = -1, pos += 3;
        } else if (peek(3) == 1) {
          kind = 1, pos += 3;
        } else if (peek(4) == 1) {
          kind = 0, pos += 4;
        } else if (peek(6) == 3) {
          kind = 2, d = 2, pos += 6;
        } else if (peek(6) == 2) {
          kind = 2, d = -2, pos += 6;
        } else if (peek(7) == 3) {
          kind = 2, d = 3, pos += 7;
        } else if (peek(7) == 2) {
          kind = 2, d = -3, pos += 7;
        } else {
          if (peek(12) == 1 && code == 4) return -2;  // EOFB before the last row
          return peek(7) == 1 ? -4 : -1;
        }
        if (kind == 0) {
          a0 = b2;
        } else if (kind == 1) {
          const int64_t start = std::max<int64_t>(a0, 0);
          const int64_t n1 = colour ? run(black_lut, 13) : run(white_lut, 12);
          if (n1 < 0) return n1;
          const int64_t n2 = colour ? run(white_lut, 12) : run(black_lut, 13);
          if (n2 < 0) return n2;
          if (start + n1 + n2 > width) return -3;
          cur.push_back(start + n1);
          cur.push_back(start + n1 + n2);
          a0 = start + n1 + n2;
        } else {
          const int64_t a1 = b1 + d;
          if (a1 < std::max<int64_t>(a0, 0) || a1 > width) return -3;
          cur.push_back(a1);
          a0 = a1;
          colour ^= 1;
        }
      }
    }
    uint8_t *row = out + r * row_bytes;
    for (size_t k = 0; k < cur.size(); k += 2) {
      const int64_t s = cur[k], t = k + 1 < cur.size() ? cur[k + 1] : width;
      for (int64_t x = s; x < t; x++) row[x >> 3] |= (uint8_t)(0x80 >> (x & 7));
    }
    ref.clear();
    for (int64_t c : cur)
      if (c < width) ref.push_back(c);
    ref.push_back(width);
    ref.push_back(width);
  }
  return 0;
}

}  // extern "C"
