// The pieces every gated walk kernel shares (walk_hit.cu: the baked walk;
// iwalk_hit.cu: the two-level vwalk and iwalk): the ray load, the block's
// conservative ray bounds, the box gate with a warp ballot, the staging of
// one chunk's plane rows, the counters, the object-space ray, the ray x
// triangle pair tests, and the lane walks, built from one staging step
// (stage_chunk: the lane-compacted pair tests and the closest hit's key
// merge): lane_walk over the baked and virtual chunks, inst_walk over
// instances and their object parts and chunks. See the notes at the top of
// walk_hit.cu and iwalk_hit.cu for the designs and the floating-point rules
// (-fmad=false; the plain torch versions in trace/walk.py and
// trace/iwalk.py repeat these expressions in this order).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment.cuh"

namespace {

constexpr int SBLK = 128;  // rays per block
constexpr int CH_W = 128;  // triangles per chunk
constexpr int WARPS = SBLK / 32;
constexpr int AUX_COLS = 24;
constexpr float EPS = 5e-4f;       // core/constants.py EPSILON
constexpr float BIG = 1e30f;       // "no winner" sentinel
constexpr float T_CLAMP = 3.0e38f; // finite stand-in for an infinite t_limit
// stats: blocks with a live lane, visits, skips, lanes, staged chunks,
// pairs; then one flag per gate entry
constexpr int NSTATS = 6;

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

__device__ __forceinline__ bool same_sign(float a, float b) {
  return (a >= 0.0f) == (b >= 0.0f);
}

__device__ __forceinline__ bool admits(float te, float win) {
  return te <= win * WIN_MUL + WIN_ADD;
}

// Load this thread's ray; invalid lanes are zeroed with t_limit 0
// (walk.py _pack_rays_cols). The first thread also records the block's
// octant from its raw direction (walk.py _block_octant).
template <class S>
__device__ Ray load_ray(const float* __restrict__ orig, const float* __restrict__ dir,
                        const float* __restrict__ tlim, int n, S& sh) {
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
template <class S>
__device__ void block_bounds(const Ray& r, S& sh) {
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

// Stage chunk c's 128 plane rows into ``planes`` (one row per thread; no
// barrier).
__device__ __forceinline__ void stage_rows(const float* __restrict__ aux, int c,
                                           float4* planes) {
  const float4* row =
      reinterpret_cast<const float4*>(aux + ((size_t)c * CH_W + threadIdx.x) * AUX_COLS);
  planes[threadIdx.x] = row[0];
  planes[CH_W + threadIdx.x] = row[1];
  planes[2 * CH_W + threadIdx.x] = row[2];
}

// Add this block's counters: stats[0] += 1 (a block with a live lane),
// stats[1] += visits, stats[2] += gated survivors the window skipped,
// stats[3] += lanes testing a staged chunk, stats[4] += staged chunks.
// Thread 0's values; call from every thread.
__device__ __forceinline__ void count(unsigned long long* stats, int anyv,
                                      unsigned long long visits, unsigned long long skips,
                                      unsigned long long lanes, unsigned long long staged) {
  if (stats != nullptr && threadIdx.x == 0 && anyv) {
    atomicAdd(stats, 1ull);
    atomicAdd(stats + 1, visits);
    atomicAdd(stats + 2, skips);
    atomicAdd(stats + 3, lanes);
    atomicAdd(stats + 4, staged);
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

// Candidate t of ray r against one plane row: whether the row is hit at
// EPS < t < r.tl, with t in ``tt`` (exact reciprocal, one Newton step).
__device__ __forceinline__ bool closest_pair(const Ray& r, float4 a, float4 b, float4 c,
                                             float& tt) {
  const Terms t = terms(r, a, b, c);
  const bool c2 = same_sign(t.ud, t.det - t.ud);
  const bool c3 = same_sign(t.vd, t.det - t.ud - t.vd);
  const float safe = t.det == 0.0f ? 1.0f : t.det;
  float rr = 1.0f / safe;
  rr = rr * (2.0f - safe * rr);  // one Newton step, as on the TPU
  tt = t.td * rr;
  return c2 && c3 && t.det != 0.0f && tt > EPS && tt < r.tl;
}

// Shadow test of ray r against one plane row, division-free: a hit iff
// sign(td - det*eps) == sign(det*tlim - td) plus the two barycentric sign
// tests (walk.py _walk_any_kernel).
__device__ __forceinline__ bool any_pair(const Ray& r, float4 a, float4 b, float4 c) {
  const Terms t = terms(r, a, b, c);
  const bool c1 = same_sign(t.td - t.det * EPS, t.det * r.tl - t.td);
  const bool c2 = same_sign(t.ud, t.det - t.ud);
  const bool c3 = same_sign(t.vd, t.det - t.ud - t.vd);
  return c1 && c2 && c3 && t.det != 0.0f;
}

// Ray r in the object space of instance i (iwalk.py _obj_rays order);
// t_limit and validity carry over unchanged (rigid transform).
__device__ __forceinline__ Ray obj_ray(const Ray& r, const float* __restrict__ inst_f, int i) {
  const float* f = inst_f + (size_t)i * 12;
  float m[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) m[j] = __ldg(f + j);
  Ray q = r;
  q.ox = m[0] * r.ox + m[1] * r.oy + m[2] * r.oz + m[9];
  q.oy = m[3] * r.ox + m[4] * r.oy + m[5] * r.oz + m[10];
  q.oz = m[6] * r.ox + m[7] * r.oy + m[8] * r.oz + m[11];
  q.dx = m[0] * r.dx + m[1] * r.dy + m[2] * r.dz;
  q.dy = m[3] * r.dx + m[4] * r.dy + m[5] * r.dz;
  q.dz = m[6] * r.dx + m[7] * r.dy + m[8] * r.dz;
  return q;
}

// --- the lane walks: walk, vwalk and iwalk, closest hit and any hit ---

// One listed lane of a staged chunk: its ray (object space for vwalk and
// iwalk), its limit in o.w (closest: min(best, t_limit) when listed; any:
// t_limit) and the lane in d.w (int bits).
struct Entry {
  float4 o, d;
};

constexpr unsigned long long NO_KEY = ~0ull;  // a listed lane without a hit

struct LaneShared {
  float4 planes[2][3 * CH_W];  // the staged chunk, double-buffered
  Entry list[2][WARPS][32];    // each warp's entering lanes, same buffers
  int cnt[2][WARPS];
  // closest: each listed lane's least (t bits << 32 | triangle) in the
  // staged chunk, same buffers; any: occluded lanes
  union {
    unsigned long long key[2][SBLK];
    int occ[SBLK];
  };
  float box[SBLK][6];          // the gate batch's boxes (slack applied)
  float te[SBLK];              // and their gate entry t
  unsigned bits[WARPS];        // gate survivors, one word per warp
  unsigned mask[3];            // block OR of the lanes' entered-box masks
  unsigned wmax[3];            // block max of the open lanes' windows (bits)
  float red[WARPS][13];
  Bounds bb;
};

// One lane's walk state: the closest hit's merged winner (best t, slot and
// instance) and the staged chunk whose key it has not merged yet (buffer
// pend, slot base pbase, instance pinst); the any hit's occluded flag as
// the lane last read it.
struct LaneState {
  float best = BIG;
  int slot = -1, inst = -1;
  int pend = -1, pbase = 0, pinst = -1;
  bool occ = false;
};

// Gate the positions [base, base + SBLK) of the block's octant order (k gate
// entries, kq columns): survivors into sh.bits (one word per warp, bit =
// lane), entry t into sh.te, and each survivor's box widened by ``slack``
// on every side into sh.box. Starts and ends with a barrier.
__device__ void gate_boxes(const float* __restrict__ cb_oct, int k, int kq, int base,
                           float slack, LaneShared& sh) {
  const int p = base + threadIdx.x;
  const float* cb = cb_oct + (size_t)sh.bb.oct * 6 * kq;
  float te = BIG;
  bool ok = false;
  if (p < k) ok = gate(sh.bb, cb, kq, p, te);
  const unsigned bits = __ballot_sync(0xffffffffu, ok);
  __syncthreads();  // the previous batch is fully consumed
  if ((threadIdx.x & 31) == 0) sh.bits[threadIdx.x / 32] = bits;
  sh.te[threadIdx.x] = te;
  if (ok) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      sh.box[threadIdx.x][a] = cb[a * kq + p] - slack;
      sh.box[threadIdx.x][3 + a] = cb[(3 + a) * kq + p] + slack;
    }
  }
  __syncthreads();
}

// The survivors of warp word w of the gate batch whose entry t the block
// window ``win`` admits (a mask of the word's bits); the others add to
// ``skips``.
__device__ __forceinline__ unsigned admitted(const LaneShared& sh, int w, float win,
                                             unsigned long long& skips) {
  unsigned todo = 0u;
  for (unsigned m = sh.bits[w]; m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    if (admits(sh.te[w * 32 + j], win)) {
      todo |= 1u << j;
    } else {
      ++skips;
    }
  }
  return todo;
}

// Block-wide OR of the lanes' masks ``mine`` and max of ``wbits`` (an open
// lane's window as float bits, 0 for a closed lane; windows are >= 0, so
// the bits order as the floats) behind one barrier: shared atomics into
// slot ``mslot`` of sh.mask / sh.wmax, three slots in rotation, so that the
// slot of the use before, read before this barrier, is cleared for the use
// after next. Returns the OR; the max into ``wmax``.
__device__ __forceinline__ unsigned block_or(LaneShared& sh, int& mslot, unsigned mine,
                                             unsigned wbits, float& wmax) {
  const unsigned wm = __reduce_or_sync(0xffffffffu, mine);
  const unsigned wt = __reduce_max_sync(0xffffffffu, wbits);
  if ((threadIdx.x & 31) == 0) {
    atomicOr(&sh.mask[mslot], wm);
    atomicMax(&sh.wmax[mslot], wt);
  }
  __syncthreads();
  const unsigned entered = sh.mask[mslot];
  wmax = __uint_as_float(sh.wmax[mslot]);
  if (threadIdx.x == 0) {
    const int prev = mslot == 0 ? 2 : mslot - 1;
    sh.mask[prev] = 0u;
    sh.wmax[prev] = 0u;
  }
  mslot = mslot == 2 ? 0 : mslot + 1;
  return entered;
}

// Closest: merge the key of the chunk this lane last listed on, once a
// barrier has passed since its tests; strict <, so of two chunks at one t
// the first visited keeps the win. Any hit: nothing.
template <bool CLOSEST>
__device__ __forceinline__ void settle(LaneState& s, const LaneShared& sh) {
  if constexpr (CLOSEST) {
    if (s.pend >= 0) {
      const unsigned long long key = sh.key[s.pend][threadIdx.x];
      const float t = __uint_as_float((unsigned)(key >> 32));
      if (key != NO_KEY && t < s.best) {
        s.best = t;
        s.slot = s.pbase + (int)(key & 0xffffffffu);
        s.inst = s.pinst;
      }
      s.pend = -1;
    }
  }
}

// One staging of a lane walk: each lane that ``want``s chunk c lists its
// ray (``ray()``, called by those lanes only: the world ray, or its
// object-space ray) with its window, the block stages the chunk's plane
// rows into buffer ``buf`` behind one barrier, and thread tid tests
// triangle tid against every listed ray, so the L x 128 pair tests of L
// listed lanes spread over all 128 threads. Closest: into the listed ray's
// 64-bit key, atomicMin(float_as_uint(t) << 32 | tid) (t > 0, so the key
// ends at the chunk's least t, then lowest lane), merged by settle() after
// the next barrier with slot base c*CH_W and instance ``inst``; any hit:
// the ray's occluded flag, an occluded listed ray skipped. Adds the listed
// lanes, the staging and the (lane, real triangle) pair tests to the
// counters; returns the block's open lanes at the barrier (closest: those
// listed; any hit: the valid lanes not known occluded, a lane hit since its
// last read counted open).
template <bool CLOSEST, class RayFn>
__device__ __forceinline__ int stage_chunk(LaneShared& sh, const float* __restrict__ aux, int c,
                                           int inst, bool want, bool valid, RayFn ray,
                                           LaneState& s, int& buf,
                                           unsigned long long& staged,
                                           unsigned long long& lanes,
                                           unsigned long long& pairs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  volatile int* occs = sh.occ;
  const unsigned b = __ballot_sync(0xffffffffu, want);
  if (want) {
    const Ray q = ray();
    Entry& en = sh.list[buf][warp][__popc(b & ((1u << lane) - 1u))];
    en.o = make_float4(q.ox, q.oy, q.oz, CLOSEST ? fminf(s.best, q.tl) : q.tl);
    en.d = make_float4(q.dx, q.dy, q.dz, __int_as_float(tid));
    if constexpr (CLOSEST) sh.key[buf][tid] = NO_KEY;
  }
  if (lane == 0) sh.cnt[buf][warp] = __popc(b);
  stage_rows(aux, c, sh.planes[buf]);
  const int open = __syncthreads_count(CLOSEST ? want : valid && !s.occ);
  if constexpr (CLOSEST) {
    settle<CLOSEST>(s, sh);  // the previous staged chunk's tests are done
    if (want) {
      s.pend = buf;
      s.pbase = c * CH_W;
      s.pinst = inst;
    }
  }
  int listed = 0;
#pragma unroll
  for (int lw = 0; lw < WARPS; ++lw) listed += sh.cnt[buf][lw];
  ++staged;
  lanes += listed;
  if (listed > 0) {
    const float4* pl = sh.planes[buf];
    const float4 pa = pl[tid], pb = pl[CH_W + tid], pc = pl[2 * CH_W + tid];
    const bool real = pa.x != 0.0f || pa.y != 0.0f || pa.z != 0.0f || pa.w != 0.0f ||
                      pb.x != 0.0f || pb.y != 0.0f || pb.z != 0.0f || pb.w != 0.0f ||
                      pc.x != 0.0f || pc.y != 0.0f || pc.z != 0.0f || pc.w != 0.0f;
    for (int lw = 0; lw < WARPS; ++lw) {
      const int cnt = sh.cnt[buf][lw];
      for (int i = 0; i < cnt; ++i) {
        const Entry en = sh.list[buf][lw][i];
        const int who = __float_as_int(en.d.w);
        if constexpr (!CLOSEST) {
          if (occs[who]) continue;
        }
        pairs += real;
        const Ray t = {en.o.x, en.o.y, en.o.z, en.d.x, en.d.y, en.d.z, en.o.w, true};
        if constexpr (CLOSEST) {
          float tt;
          if (closest_pair(t, pa, pb, pc, tt)) {
            atomicMin(&sh.key[buf][who],
                      ((unsigned long long)__float_as_uint(tt) << 32) | (unsigned)tid);
          }
        } else {
          if (any_pair(t, pa, pb, pc)) occs[who] = 1;
        }
      }
    }
  }
  // any hit: later hits by other threads show at the next read
  if constexpr (!CLOSEST) s.occ = occs[tid] != 0;
  buf ^= 1;
  return open;
}

// Add v, summed over the warp, to *dst (one atomic per warp).
__device__ __forceinline__ void warp_add(unsigned long long* dst, unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(dst, v);
}

// The lane walks' end: after a barrier, merge the last key, write the
// outputs (closest: best t, slot and, where out_inst is given, the
// instance; any hit: the occluded flag), and add the counters (count(),
// then stats[5] += pairs).
template <bool CLOSEST>
__device__ __forceinline__ void finish_walk(LaneShared& sh, LaneState& s, int n,
                                            float* __restrict__ out_t,
                                            int* __restrict__ out_slot,
                                            int* __restrict__ out_inst,
                                            uint8_t* __restrict__ out_any,
                                            unsigned long long* __restrict__ stats,
                                            unsigned long long visits, unsigned long long skips,
                                            unsigned long long lanes, unsigned long long staged,
                                            unsigned long long pairs) {
  __syncthreads();
  settle<CLOSEST>(s, sh);
  const int ray = blockIdx.x * SBLK + threadIdx.x;
  if (ray < n) {
    if constexpr (CLOSEST) {
      out_t[ray] = s.best;
      out_slot[ray] = s.slot;
      if (out_inst != nullptr) out_inst[ray] = s.slot >= 0 ? s.inst : -1;
    } else {
      out_any[ray] = sh.occ[threadIdx.x] != 0 ? 1 : 0;
    }
  }
  count(stats, sh.bb.anyv, visits, skips, lanes, staged);
  if (stats != nullptr && sh.bb.anyv) warp_add(stats + 5, pairs);
}

// The chunk of gate entry e: the layout chunk e, or virtual chunk e's
// object chunk.
template <bool VIRTUAL>
__device__ __forceinline__ int entry_chunk(const int* __restrict__ vglob, int e) {
  if constexpr (VIRTUAL) {
    return vglob[e];
  } else {
    return e;
  }
}

// The walk over baked chunks (VIRTUAL false: a gate entry e is the layout
// chunk e) or virtual chunks (VIRTUAL true: the object chunk vglob[e] of
// instance vinst[e], tested on the lane's object-space ray), as a closest
// hit (CLOSEST true: out_t, out_slot and, vwalk, out_inst) or a shadow test
// (one flag per ray in out_any). ``stats`` as count() plus stats[5] +=
// pairs and a flag per staged gate entry at stats[NSTATS + e]. The design
// is in the note at the top of walk_hit.cu.
template <bool VIRTUAL, bool CLOSEST>
__device__ __forceinline__ void lane_walk(
    const float* __restrict__ aux, const float* __restrict__ cb_oct,
    const int* __restrict__ ord_oct, const int* __restrict__ vinst,
    const int* __restrict__ vglob, const float* __restrict__ inst_f, int k, int kq,
    float slack, const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ tlim, int n, float* __restrict__ out_t,
    int* __restrict__ out_slot, int* __restrict__ out_inst, uint8_t* __restrict__ out_any,
    unsigned long long* __restrict__ stats) {
  __shared__ LaneShared sh;
  const int tid = threadIdx.x;
  if constexpr (!CLOSEST) sh.occ[tid] = 0;
  if (tid < 3) {
    sh.mask[tid] = 0u;
    sh.wmax[tid] = 0u;
  }
  const Ray r = load_ray(orig, dir, tlim, n, sh);
  block_bounds(r, sh);  // its barrier publishes the zeroed flags too
  const float o[3] = {r.ox, r.oy, r.oz}, d[3] = {r.dx, r.dy, r.dz};
  const float inv[3] = {r.dx == 0.0f ? 0.0f : 1.0f / r.dx, r.dy == 0.0f ? 0.0f : 1.0f / r.dy,
                        r.dz == 0.0f ? 0.0f : 1.0f / r.dz};

  LaneState s;
  unsigned long long visits = 0, skips = 0, lanes = 0, staged = 0, pairs = 0;
  if (sh.bb.anyv) {
    const int* ord = ord_oct + (size_t)sh.bb.oct * kq;
    float win = sh.bb.tmax;  // uniform; any hit: 0 once every live lane is occluded
    int mslot = 0, buf = 0;
    for (int base = 0; base < k && win > 0.0f; base += SBLK) {
      gate_boxes(cb_oct, k, kq, base, slack, sh);
      settle<CLOSEST>(s, sh);
      for (int w = 0; w < WARPS && win > 0.0f; ++w) {
        // this warp word's survivors within the block window
        const unsigned todo = admitted(sh, w, win, skips);
        visits += __popc(todo);
        if (todo == 0u) continue;
        // each live (any hit: unoccluded) lane's own segment test of every
        // box of the word within its window; the masks are ORed and the
        // windows' max taken block-wide behind one barrier
        const bool open = CLOSEST ? r.valid : r.valid && !s.occ;
        const float tw = CLOSEST ? fminf(s.best, r.tl) : r.tl;
        unsigned mine = 0u;
        if (open) {
          for (unsigned m = todo; m; m &= m - 1) {
            const int j = __ffs(m) - 1;
            if (enters(o, d, inv, sh.box[w * 32 + j], tw)) mine |= 1u << j;
          }
        }
        float wmax;
        const unsigned entered = block_or(sh, mslot, mine, open ? __float_as_uint(tw) : 0u, wmax);
        settle<CLOSEST>(s, sh);
        win = fminf(win, wmax);
        // stage each entered box's chunk, in visit order; only the entering
        // lanes test it (closest: those that still enter it within their
        // window, which may have fallen since the mask)
        for (unsigned m = entered; m; m &= m - 1) {
          const int j = __ffs(m) - 1;
          const int e = ord[base + w * 32 + j];
          bool want = (mine >> j) & 1u;
          if constexpr (CLOSEST) {
            want = want && enters(o, d, inv, sh.box[w * 32 + j], fminf(s.best, r.tl));
          } else {
            want = want && !s.occ;
          }
          if (stats != nullptr && tid == 0) stats[NSTATS + e] = 1ull;
          stage_chunk<CLOSEST>(
              sh, aux, entry_chunk<VIRTUAL>(vglob, e), VIRTUAL ? vinst[e] : -1, want, r.valid,
              [&]() -> Ray {
                if constexpr (VIRTUAL) {
                  return obj_ray(r, inst_f, vinst[e]);
                } else {
                  return r;
                }
              },
              s, buf, staged, lanes, pairs);
        }
      }
    }
  }
  finish_walk<CLOSEST>(sh, s, n, out_t, out_slot, VIRTUAL ? out_inst : nullptr, out_any, stats,
                       visits, skips, lanes, staged, pairs);
}

// iwalk's counters: lane_walk's six, then the (lane, instance), (lane,
// part) and (lane, chunk) box tests that entered; then one flag per
// instance entered.
constexpr int NSTATS_IWALK = 9;

// The instance walk (iwalk), as a closest hit (CLOSEST true: out_t,
// out_slot, out_inst) or a shadow test (out_any): a gate entry is an
// instance, its world box widened by ``slack``; under it each entering
// lane culls the instance's object parts (``opb`` [P, 6], ``inst_p`` [I, 2]
// each instance's part range) and the object chunks (``ocb`` [K, 6],
// ``part_c`` [P, 2] each part's chunk range) of the parts it enters, on its
// object-space ray, and each chunk some lane enters is staged for the
// lanes that enter it. The design is in the note at the top of
// iwalk_hit.cu. ``stats`` as lane_walk's, plus stats[6..8] (NSTATS_IWALK)
// and a flag per entered instance at stats[NSTATS_IWALK + i].
template <bool CLOSEST>
__device__ __forceinline__ void inst_walk(
    const float* __restrict__ aux, const float* __restrict__ cb_oct,
    const int* __restrict__ ord_oct, const int* __restrict__ inst_p,
    const int* __restrict__ part_c, const float* __restrict__ ocb,
    const float* __restrict__ opb, const float* __restrict__ inst_f, int k, int kq,
    float slack, const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ tlim, int n, float* __restrict__ out_t,
    int* __restrict__ out_slot, int* __restrict__ out_inst, uint8_t* __restrict__ out_any,
    unsigned long long* __restrict__ stats) {
  __shared__ LaneShared sh;
  const int tid = threadIdx.x;
  if constexpr (!CLOSEST) sh.occ[tid] = 0;
  if (tid < 3) {
    sh.mask[tid] = 0u;
    sh.wmax[tid] = 0u;
  }
  const Ray r = load_ray(orig, dir, tlim, n, sh);
  block_bounds(r, sh);  // its barrier publishes the zeroed flags too
  const float o[3] = {r.ox, r.oy, r.oz}, d[3] = {r.dx, r.dy, r.dz};
  const float inv[3] = {r.dx == 0.0f ? 0.0f : 1.0f / r.dx, r.dy == 0.0f ? 0.0f : 1.0f / r.dy,
                        r.dz == 0.0f ? 0.0f : 1.0f / r.dz};

  LaneState s;
  unsigned long long visits = 0, skips = 0, lanes = 0, staged = 0, pairs = 0;
  unsigned insts_n = 0, parts_n = 0, chunks_n = 0;
  if (sh.bb.anyv) {
    const int* ord = ord_oct + (size_t)sh.bb.oct * kq;
    float win = sh.bb.tmax;  // uniform; any hit: 0 once every valid lane is occluded
    int mslot = 0, buf = 0;
    for (int base = 0; base < k && win > 0.0f; base += SBLK) {
      gate_boxes(cb_oct, k, kq, base, slack, sh);
      settle<CLOSEST>(s, sh);
      for (int w = 0; w < WARPS && win > 0.0f; ++w) {
        const unsigned todo = admitted(sh, w, win, skips);
        visits += __popc(todo);
        if (todo == 0u) continue;
        // level 1: each open lane's test of the word's instance boxes
        const bool open = CLOSEST ? r.valid : r.valid && !s.occ;
        const float tw = CLOSEST ? fminf(s.best, r.tl) : r.tl;
        unsigned mine = 0u;
        if (open) {
          for (unsigned m = todo; m; m &= m - 1) {
            const int j = __ffs(m) - 1;
            if (enters(o, d, inv, sh.box[w * 32 + j], tw)) mine |= 1u << j;
          }
        }
        insts_n += __popc(mine);
        float wmax;
        const unsigned entered = block_or(sh, mslot, mine, open ? __float_as_uint(tw) : 0u, wmax);
        settle<CLOSEST>(s, sh);
        win = fminf(win, wmax);
        // each entered instance in visit order
        for (unsigned m = entered; m && win > 0.0f; m &= m - 1) {
          const int j = __ffs(m) - 1;
          const int i = ord[base + w * 32 + j];
          bool in = (mine >> j) & 1u;
          if constexpr (CLOSEST) {
            in = in && enters(o, d, inv, sh.box[w * 32 + j], fminf(s.best, r.tl));
          }
          // the lane's object-space ray, once per instance it enters
          const Ray q = in ? obj_ray(r, inst_f, i) : r;
          const float qo[3] = {q.ox, q.oy, q.oz}, qd[3] = {q.dx, q.dy, q.dz};
          const float qinv[3] = {q.dx == 0.0f ? 0.0f : 1.0f / q.dx,
                                 q.dy == 0.0f ? 0.0f : 1.0f / q.dy,
                                 q.dz == 0.0f ? 0.0f : 1.0f / q.dz};
          if (stats != nullptr && tid == 0) stats[NSTATS_IWALK + i] = 1ull;
          const int p0 = inst_p[2 * i], p1 = inst_p[2 * i + 1];
          for (int pw = p0; pw < p1 && win > 0.0f; pw += 32) {
            // level 2: the lanes in the instance test a word of its part
            // boxes; ORed block-wide unless the word holds one part
            const int np = min(32, p1 - pw);
            unsigned pm = 0u;
            if (in && (CLOSEST || !s.occ)) {
              const float tp = CLOSEST ? fminf(s.best, r.tl) : r.tl;
              for (int b = 0; b < np; ++b) {
                if (enters(qo, qd, qinv, opb + (size_t)(pw + b) * 6, tp)) pm |= 1u << b;
              }
            }
            parts_n += __popc(pm);
            unsigned pent = 1u;
            if (np > 1) {
              const bool popen = CLOSEST ? r.valid : r.valid && !s.occ;
              float pmax;
              pent = block_or(sh, mslot, pm, popen ? __float_as_uint(r.tl) : 0u, pmax);
              settle<CLOSEST>(s, sh);
              if (pmax == 0.0f) win = 0.0f;  // any hit: every valid lane occluded
            }
            for (unsigned mp = pent; mp && win > 0.0f; mp &= mp - 1) {
              // level 3: the lanes in the part test its chunk boxes
              const int b = __ffs(mp) - 1;
              const int c0 = part_c[2 * (pw + b)], c1 = part_c[2 * (pw + b) + 1];
              unsigned cm = 0u;
              if (((pm >> b) & 1u) && (CLOSEST || !s.occ)) {
                const float tc = CLOSEST ? fminf(s.best, r.tl) : r.tl;
                for (int c = c0; c < c1; ++c) {
                  if (enters(qo, qd, qinv, ocb + (size_t)c * 6, tc)) cm |= 1u << (c - c0);
                }
              }
              chunks_n += __popc(cm);
              const bool copen = CLOSEST ? r.valid : r.valid && !s.occ;
              float cmax;
              const unsigned cent =
                  block_or(sh, mslot, cm, copen ? __float_as_uint(r.tl) : 0u, cmax);
              settle<CLOSEST>(s, sh);
              if (cmax == 0.0f) {
                win = 0.0f;  // any hit: every valid lane occluded
                break;
              }
              // stage each entered chunk in ascending index, for the lanes
              // that (closest: still) enter it
              for (unsigned mc = cent; mc; mc &= mc - 1) {
                const int c = c0 + __ffs(mc) - 1;
                bool want = (cm >> (c - c0)) & 1u;
                if constexpr (CLOSEST) {
                  want = want && enters(qo, qd, qinv, ocb + (size_t)c * 6, fminf(s.best, r.tl));
                } else {
                  want = want && !s.occ;
                }
                const int left = stage_chunk<CLOSEST>(sh, aux, c, i, want, r.valid,
                                                      [&]() { return q; }, s, buf, staged,
                                                      lanes, pairs);
                if (left == 0 && !CLOSEST) {
                  win = 0.0f;  // every valid lane occluded
                  break;
                }
              }
            }
          }
        }
      }
    }
  }
  finish_walk<CLOSEST>(sh, s, n, out_t, out_slot, out_inst, out_any, stats, visits, skips, lanes,
                       staged, pairs);
  if (stats != nullptr && sh.bb.anyv) {
    warp_add(stats + NSTATS, insts_n);
    warp_add(stats + NSTATS + 1, parts_n);
    warp_add(stats + NSTATS + 2, chunks_n);
  }
}

}  // namespace
