// The pieces every gated walk kernel shares (walk_hit.cu: the baked walk;
// iwalk_hit.cu: the two-level vwalk and iwalk): the ray load, the block's
// conservative ray bounds, the box gate with a warp ballot, the staging of
// one chunk's plane rows, the block-wide window reduction, the counters and
// the ray x triangle pair tests. See the note at the top of walk_hit.cu for
// the design and the floating-point rules (-fmad=false; the plain torch
// versions in trace/walk.py and trace/iwalk.py repeat these expressions in
// this order).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SBLK = 128;  // rays per block
constexpr int CH_W = 128;  // triangles per chunk
constexpr int WARPS = SBLK / 32;
constexpr int AUX_COLS = 24;
constexpr float EPS = 5e-4f;       // core/constants.py EPSILON
constexpr float BIG = 1e30f;       // "no winner" sentinel
constexpr float T_CLAMP = 3.0e38f; // finite stand-in for an infinite t_limit
constexpr float WIN_MUL = 1.00002f;
constexpr float WIN_ADD = 1e-5f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tl;
  bool valid;
};

// Conservative bounds of the block's valid lanes (walk.py _block_bounds).
struct Bounds {
  float olo[3], ohi[3], rlo[3], rhi[3];
  bool crosses[3];
  float tmax;
  int anyv;
  int oct;  // direction octant of the block's first ray
};

struct Shared {
  float4 planes[3 * CH_W];  // n0|d0, n1|d1, n2|d2 of the staged chunk
  float red[WARPS][13];
  float win[WARPS];
  float te[SBLK];
  unsigned bits[WARPS];
  Bounds bb;
};

__device__ __forceinline__ bool same_sign(float a, float b) {
  return (a >= 0.0f) == (b >= 0.0f);
}

__device__ __forceinline__ bool admits(float te, float win) {
  return te <= win * WIN_MUL + WIN_ADD;
}

// Load this thread's ray; invalid lanes are zeroed with t_limit 0
// (walk.py _pack_rays_cols). The first thread also records the block's
// octant from its raw direction (walk.py _block_octant).
__device__ Ray load_ray(const float* __restrict__ orig, const float* __restrict__ dir,
                        const float* __restrict__ tlim, int n, Shared& sh) {
  const int ray = blockIdx.x * SBLK + threadIdx.x;
  Ray r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false};
  if (ray < n) {
    r.ox = orig[3 * ray];
    r.oy = orig[3 * ray + 1];
    r.oz = orig[3 * ray + 2];
    r.dx = dir[3 * ray];
    r.dy = dir[3 * ray + 1];
    r.dz = dir[3 * ray + 2];
    r.tl = tlim[ray];
    if (threadIdx.x == 0) {
      sh.bb.oct = ((r.dx < 0.f) << 2) | ((r.dy < 0.f) << 1) | (r.dz < 0.f);
    }
    r.valid = r.tl > 0.0f && isfinite(r.ox) && isfinite(r.oy) && isfinite(r.oz) &&
              isfinite(r.dx) && isfinite(r.dy) && isfinite(r.dz);
  }
  if (r.valid) {
    r.tl = fminf(r.tl, T_CLAMP);
  } else {
    r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false};
  }
  return r;
}

// Block-wide conservative ray bounds into sh.bb; every thread returns after
// the barrier that publishes them.
__device__ void block_bounds(const Ray& r, Shared& sh) {
  // olo xyz (min) | ohi xyz (max) | dlo xyz (min) | dhi xyz (max) | tmax (max)
  float v[13];
  v[0] = r.valid ? r.ox : BIG;
  v[1] = r.valid ? r.oy : BIG;
  v[2] = r.valid ? r.oz : BIG;
  v[3] = r.valid ? r.ox : -BIG;
  v[4] = r.valid ? r.oy : -BIG;
  v[5] = r.valid ? r.oz : -BIG;
  v[6] = r.valid ? r.dx : BIG;
  v[7] = r.valid ? r.dy : BIG;
  v[8] = r.valid ? r.dz : BIG;
  v[9] = r.valid ? r.dx : -BIG;
  v[10] = r.valid ? r.dy : -BIG;
  v[11] = r.valid ? r.dz : -BIG;
  v[12] = r.valid ? r.tl : 0.0f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 13; ++i) {
      const float o = __shfl_xor_sync(0xffffffffu, v[i], off);
      const bool is_min = (i < 3) || (i >= 6 && i < 9);
      v[i] = is_min ? fminf(v[i], o) : fmaxf(v[i], o);
    }
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < 13; ++i) sh.red[warp][i] = v[i];
  }
  const int anyv = __syncthreads_or(r.valid);
  if (threadIdx.x == 0) {
    Bounds& b = sh.bb;
    b.anyv = anyv;
    float t[13];
#pragma unroll
    for (int i = 0; i < 13; ++i) {
      t[i] = sh.red[0][i];
      const bool is_min = (i < 3) || (i >= 6 && i < 9);
      for (int w = 1; w < WARPS; ++w) {
        t[i] = is_min ? fminf(t[i], sh.red[w][i]) : fmaxf(t[i], sh.red[w][i]);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float dlo = t[6 + a], dhi = t[9 + a];
      b.olo[a] = t[a];
      b.ohi[a] = t[3 + a];
      b.crosses[a] = dlo <= 0.0f && dhi >= 0.0f;
      b.rlo[a] = b.crosses[a] ? 0.0f : 1.0f / (dlo == 0.0f ? 1.0f : dlo);
      b.rhi[a] = b.crosses[a] ? 0.0f : 1.0f / (dhi == 0.0f ? 1.0f : dhi);
    }
    b.tmax = t[12];
  }
  __syncthreads();
}

// Conservative slab test of the box at octant-order position p against the
// block's bounds (walk.py _slab_lo_hi); te = entry t.
__device__ __forceinline__ bool gate(const Bounds& b, const float* __restrict__ cb,
                                     int kq, int p, float& te) {
  float t_lo = 0.0f, t_hi = b.tmax;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float nlo = cb[a * kq + p] - b.ohi[a];
    const float nhi = cb[(3 + a) * kq + p] - b.olo[a];
    const float c0 = nlo * b.rlo[a], c1 = nlo * b.rhi[a];
    const float c2 = nhi * b.rlo[a], c3 = nhi * b.rhi[a];
    const float lo_a = fminf(fminf(c0, c1), fminf(c2, c3));
    const float hi_a = fmaxf(fmaxf(c0, c1), fmaxf(c2, c3));
    t_lo = fmaxf(t_lo, b.crosses[a] ? -BIG : lo_a);
    t_hi = fminf(t_hi, b.crosses[a] ? BIG : hi_a);
  }
  te = t_lo;
  return t_lo <= t_hi;
}

// Gate the positions [base, base + SBLK) of the block's octant order (k gate
// entries, kq columns): survivors into sh.bits (one word per warp, bit =
// lane), entry t into sh.te. Ends with the barrier that publishes them.
__device__ void gate_batch(const float* __restrict__ cb_oct, int k, int kq, int base,
                           Shared& sh) {
  const int p = base + threadIdx.x;
  float te = BIG;
  bool ok = false;
  if (p < k) ok = gate(sh.bb, cb_oct + (size_t)sh.bb.oct * 6 * kq, kq, p, te);
  const unsigned bits = __ballot_sync(0xffffffffu, ok);
  __syncthreads();  // the previous batch is fully consumed
  if ((threadIdx.x & 31) == 0) sh.bits[threadIdx.x / 32] = bits;
  sh.te[threadIdx.x] = te;
  __syncthreads();
}

// Stage chunk c's 128 plane rows into shared memory (then a barrier).
__device__ __forceinline__ void stage(const float* __restrict__ aux, int c, Shared& sh) {
  const float4* row =
      reinterpret_cast<const float4*>(aux + ((size_t)c * CH_W + threadIdx.x) * AUX_COLS);
  sh.planes[threadIdx.x] = row[0];
  sh.planes[CH_W + threadIdx.x] = row[1];
  sh.planes[2 * CH_W + threadIdx.x] = row[2];
  __syncthreads();
}

// Block-wide max of x (then a barrier); every thread gets the result.
__device__ __forceinline__ float block_max(float x, Shared& sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) sh.win[threadIdx.x / 32] = x;
  __syncthreads();
  float m = sh.win[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, sh.win[w]);
  return m;
}

// Counters of one visit: flag gate entry e in ``flags``, return the block's
// count of testing lanes. A barrier: call it from every thread.
__device__ __forceinline__ int mark(unsigned long long* flags, int e, bool tests) {
  if (threadIdx.x == 0) flags[e] = 1ull;
  return __syncthreads_count(tests);
}

// Add this block's counters: stats[0] += 1 (a block with a live lane),
// stats[1] += visits, stats[2] += gated survivors the window skipped,
// stats[3] += lanes testing a staged chunk.
__device__ __forceinline__ void count(unsigned long long* stats, int anyv,
                                      unsigned long long visits, unsigned long long skips,
                                      unsigned long long lanes) {
  if (stats != nullptr && threadIdx.x == 0 && anyv) {
    atomicAdd(stats, 1ull);
    atomicAdd(stats + 1, visits);
    atomicAdd(stats + 2, skips);
    atomicAdd(stats + 3, lanes);
  }
}

// p-form Havel-Herout terms of the JAX _chunk_terms, in its order.
struct Terms {
  float det, td, ud, vd;
};

__device__ __forceinline__ Terms terms(const Ray& r, float4 a, float4 b, float4 c) {
  Terms q;
  q.det = a.x * r.dx + a.y * r.dy + a.z * r.dz;
  q.td = a.w - (a.x * r.ox + a.y * r.oy + a.z * r.oz);
  const float px = q.det * r.ox + q.td * r.dx;
  const float py = q.det * r.oy + q.td * r.dy;
  const float pz = q.det * r.oz + q.td * r.dz;
  q.ud = b.x * px + b.y * py + b.z * pz + q.det * b.w;
  q.vd = c.x * px + c.y * py + c.z * pz + q.det * c.w;
  return q;
}

// Closest hit of ray r against the staged chunk c: lowers best and sets
// slot = c*CH_W + lane on a nearer hit; returns whether it did. Strict <:
// the first visited chunk, then the lowest lane, wins ties.
__device__ __forceinline__ bool closest_chunk(const Ray& r, const Shared& sh, int c,
                                              float& best, int& slot) {
  bool upd = false;
  for (int j = 0; j < CH_W; ++j) {
    const Terms t = terms(r, sh.planes[j], sh.planes[CH_W + j], sh.planes[2 * CH_W + j]);
    const bool c2 = same_sign(t.ud, t.det - t.ud);
    const bool c3 = same_sign(t.vd, t.det - t.ud - t.vd);
    const float safe = t.det == 0.0f ? 1.0f : t.det;
    float rr = 1.0f / safe;
    rr = rr * (2.0f - safe * rr);  // one Newton step, as on the TPU
    const float tt = t.td * rr;
    if (c2 && c3 && t.det != 0.0f && tt > EPS && tt < r.tl && tt < best) {
      best = tt;
      slot = c * CH_W + j;
      upd = true;
    }
  }
  return upd;
}

// Shadow test of ray r against the staged chunk, division-free: a hit iff
// sign(td - det*eps) == sign(det*tlim - td) plus the two barycentric sign
// tests (walk.py _walk_any_kernel).
__device__ __forceinline__ bool any_chunk(const Ray& r, const Shared& sh) {
  for (int j = 0; j < CH_W; ++j) {
    const Terms t = terms(r, sh.planes[j], sh.planes[CH_W + j], sh.planes[2 * CH_W + j]);
    const bool c1 = same_sign(t.td - t.det * EPS, t.det * r.tl - t.td);
    const bool c2 = same_sign(t.ud, t.det - t.ud);
    const bool c3 = same_sign(t.vd, t.det - t.ud - t.vd);
    if (c1 && c2 && c3 && t.det != 0.0f) return true;
  }
  return false;
}

}  // namespace
