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
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
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

}  // extern "C"
