// Streamed dense closest-hit and any-hit over one table of up to 2M
// triangles, for Hopper: the world queries of a baked soup above 16,384
// triangles when the walk is switched off (PT_WALK=0, Scene.device(...,
// engine="stream")), and of every soup of 1,572,865-2,000,000 triangles.
//
// Replaces path_tracer_tpu/trace/dense_stream.py::_stream_closest_kernel and
// ::_stream_any_kernel (contract: dense_stream_closest_hit_shade /
// dense_stream_any_hit there). The TPU kernels double-buffer part tables
// through VMEM and keep every ray block's state resident; here device memory
// holds the table and each ray block walks it on its own.
//
// Tables (trace/dense_stream.py pack_dense_stream):
//   aux [nparts*cpp*512, 24] f32, one row per triangle in the soup's order,
//       fixed-stride padded (row index == soup index; pad rows are zero:
//       det == 0, they never hit): cols 0-3 n0.xyz d0 | 4-7 n1.xyz d1 |
//       8-11 n2.xyz d2 | ...
//   pab [nparts, 6] f32, part boxes (lo xyz | hi xyz) of cpp <= 32 chunks
//   cab [nparts*cpp, 6] f32, chunk boxes of 512 rows each
//   qab [nparts*cpp*4, 6] f32, group boxes of 128 rows each
// all padded alike (1e-4 of the scene's scale), pad chunks and groups
// inverted, so a group's box lies inside its chunk's and a chunk's inside
// its part's. Rays arrive in the caller's order; the wrapper checks shapes
// and types.
//
// Design. One block of 128 threads per block of 128 rays. Invalid lanes
// (t_limit <= 0 or a non-finite origin/direction) take no part and never
// hit; t_limit is clamped finite. A per-lane cull in three levels, each
// lane's own slab test (segment.cuh enters) within its own window (closest:
// min(best, t_limit); any hit: t_limit while unoccluded), visited in
// ascending index:
//   1. the part boxes, a warp word of 32 at a time (held in shared memory);
//      the lanes' masks are ORed block-wide behind one barrier;
//   2. for each part some lane entered, the lanes that entered it test its
//      chunk boxes, and for each chunk they enter its four group boxes: a
//      mask of the part's (at most 128) groups per lane, ORed block-wide
//      behind one barrier;
//   3. each group some lane entered is staged: the lanes that want it
//      (closest: those that still enter it within their window, which may
//      have fallen since) list their rays in shared memory, and each of the
//      128 threads takes one row of the group into registers and tests it
//      against every listed ray (the soup's last group too: its pad rows
//      are zero and never hit). One barrier per group: the lists and keys
//      are double-buffered. A group no lane lists is not tested.
// Every level is exact: a triangle lies in its group's padded box, inside
// its chunk's, inside its part's, and the slab test is monotone in the box,
// so a lane that holds a hit in a group enters all three. No block gate: a
// bounce block crosses 0 on every direction axis, where it admits all.
//
// The tie rule. A closest hit is merged through a 64-bit key per listed
// lane, atomicMin(float_as_uint(t) << 32 | row), row the soup index: t > 0,
// so the key ends at the group's least t, then lowest row, whatever the
// atomics' order. The lane merges its key after the next barrier with a
// strict < on t; groups come in ascending soup index, so of two groups at
// one t the lower keeps the win: the lowest soup index wins a tie, as in
// the plain version. Until a key is merged the lane's window is its older,
// larger best: conservative, so the cull stays exact.
//
// The any hit flags an occluded lane in shared memory; the lane then stops
// testing, and the block leaves at the next group's barrier once every
// valid lane is occluded.
//
// What bounds it: the least time is FP32 ALU per needed ray x row pair
// (closest 47 ops, any 46, as in dense_hit.cu), plus ~30 per (lane, box)
// slab test. On the card the kernels run well above it, and not for the
// staged bytes (48 B of planes per row of each staged group): a block
// stages the groups its lanes enter one after another, a barrier each for
// a few listed lanes, and the blocks whose lanes scatter (bounce and shadow
// rays in pixel order) stage several times the mean and set the launch's
// time.
//
// Counters. With a non-null ``stats`` ([8] u64, zeroed by the caller) each
// block with a valid lane adds 1 to stats[0], its valid lanes to stats[1],
// the (lane, group) box tests that entered to stats[2], the groups it
// stages (those some lane lists) to stats[3], the lanes listed on them to
// stats[4], the (lane, row) pairs tested (pad rows of the soup's last group
// included) to stats[5], and the (lane, part) and
// (lane, chunk) box tests that entered to stats[6] and stats[7]. Off (null)
// on the main path.
//
// Floating point. Built with -fmad=false (trace/cuda_lib.py): the candidate
// t is dense_hit.cu's (1/det plus one Newton step), so best t and the winner
// equal the plain torch version's (trace/dense_stream.py) bit for bit.

#include "dense_common.cuh"
#include "segment.cuh"

namespace {

constexpr int SBLK = 128;        // rays per block (dense_stream.py SBLK)
constexpr int CH = 512;          // rows per chunk (dense_stream.py CH)
constexpr int QH = 128;          // rows per group (dense_stream.py QH)
constexpr int QPC = CH / QH;     // groups per chunk
constexpr int MAX_CPP = 32;      // chunks per part: PART_TRIS / CH
constexpr int MAX_PARTS = 128;   // a 2M-triangle soup has 123
constexpr int WARPS = SBLK / 32;
constexpr int GWORDS = MAX_CPP * QPC / 32;  // group-mask words per part
constexpr float T_CLAMP = 3.0e38f;  // finite stand-in for an infinite t_limit
constexpr unsigned long long NO_KEY = ~0ull;  // a listed lane without a hit

struct Ray {
  float o[3], d[3], inv[3];
  float tl;
  bool valid;
};

// One listed lane of a staged group: its ray, its window in o.w and the
// lane in d.w (int bits).
struct Entry {
  float4 o, d;
};

struct Shared {
  Entry list[2][WARPS][32];  // each warp's listed lanes, double-buffered
  int cnt[2][WARPS];
  // closest: each listed lane's least (t bits << 32 | row) in the group,
  // same buffers; any hit: occluded lanes
  union {
    unsigned long long key[2][SBLK];
    int occ[SBLK];
  };
  float pbox[MAX_PARTS][6];
  unsigned pmask[MAX_PARTS / 32];      // block OR of the lanes' entered parts
  unsigned gmask[MAX_PARTS][GWORDS];   // and of each part's entered groups
};

// This thread's ray; an invalid lane is zeroed with t_limit 0.
__device__ Ray load_ray(const float* __restrict__ orig, const float* __restrict__ dir,
                        const float* __restrict__ tlim, int n) {
  const int ray = blockIdx.x * SBLK + threadIdx.x;
  Ray r = {};
  if (ray < n) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      r.o[a] = orig[3 * ray + a];
      r.d[a] = dir[3 * ray + a];
    }
    r.tl = tlim[ray];
    r.valid = r.tl > 0.0f && isfinite(r.o[0]) && isfinite(r.o[1]) && isfinite(r.o[2]) &&
              isfinite(r.d[0]) && isfinite(r.d[1]) && isfinite(r.d[2]);
  }
  if (r.valid) {
    r.tl = fminf(r.tl, T_CLAMP);
  } else {
    r = {};
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) r.inv[a] = r.d[a] == 0.0f ? 0.0f : 1.0f / r.d[a];
  return r;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The walk over the soup's parts, chunks and groups, as a closest hit
// (CLOSEST true: best search t and soup index into out_t / out_idx) or a
// shadow test (one flag per ray into out_any). The design is in the note at
// the top.
template <bool CLOSEST>
__device__ __forceinline__ void stream_walk(
    const float* __restrict__ aux, const float* __restrict__ cab, const float* __restrict__ pab,
    const float* __restrict__ qab, int nparts, int cpp, const float* __restrict__ orig,
    const float* __restrict__ dir, const float* __restrict__ tlim, int n, float* __restrict__ out_t,
    int* __restrict__ out_idx, uint8_t* __restrict__ out_any,
    unsigned long long* __restrict__ stats) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gpp = cpp * QPC;  // groups per part
  volatile int* occs = sh.occ;

  const Ray r = load_ray(orig, dir, tlim, n);
  if constexpr (!CLOSEST) occs[tid] = 0;
  if (tid < MAX_PARTS / 32) sh.pmask[tid] = 0u;
  for (int i = tid; i < MAX_PARTS * GWORDS; i += SBLK) (&sh.gmask[0][0])[i] = 0u;
  for (int i = tid; i < nparts * 6; i += SBLK) (&sh.pbox[0][0])[i] = pab[i];
  const int live = __syncthreads_count(r.valid);

  bool occ = false;   // any hit
  float best = BIG;   // closest: the merged winner,
  int best_row = -1;
  int pend = -1;      // and the buffer whose key is not yet merged
  // closest: merge the key of the group this lane last listed on, once a
  // barrier has passed since its tests; strict <, so of two groups at one
  // t the lower (visited first) keeps the win
  auto settle = [&]() {
    if constexpr (CLOSEST) {
      if (pend >= 0) {
        const unsigned long long key = sh.key[pend][tid];
        const float t = __uint_as_float((unsigned)(key >> 32));
        if (key != NO_KEY && t < best) {
          best = t;
          best_row = (int)(key & 0xffffffffu);
        }
        pend = -1;
      }
    }
  };
  unsigned long long parts_n = 0, chunks_n = 0, groups_n = 0, staged = 0, listed_n = 0,
                     pairs = 0;
  if (live > 0) {
    int buf = 0;
    bool done = false;  // any hit: every valid lane is occluded
    for (int w = 0; w * 32 < nparts && !done; ++w) {
      // level 1: each open lane's test of the word's part boxes
      const bool open = CLOSEST ? r.valid : r.valid && !occ;
      const float tw = CLOSEST ? fminf(best, r.tl) : r.tl;
      const int nw = min(32, nparts - 32 * w);
      unsigned mine = 0u;
      if (open) {
        for (int j = 0; j < nw; ++j) {
          if (enters(r.o, r.d, r.inv, sh.pbox[32 * w + j], tw)) mine |= 1u << j;
        }
      }
      parts_n += __popc(mine);
      const unsigned wm = __reduce_or_sync(0xffffffffu, mine);
      if (lane == 0 && wm != 0u) atomicOr(&sh.pmask[w], wm);
      if (!__syncthreads_or(open)) break;
      settle();
      for (unsigned pm = sh.pmask[w]; pm && !done; pm &= pm - 1) {
        const int p = 32 * w + __ffs(pm) - 1;
        // levels 2 and 3: the part's chunk boxes, then the group boxes of
        // each chunk entered, by the lanes that entered the part
        unsigned gm[GWORDS] = {0u, 0u, 0u, 0u};
        if (((mine >> (p - 32 * w)) & 1u) && (CLOSEST || !occ)) {
          const float tp = CLOSEST ? fminf(best, r.tl) : r.tl;
#pragma unroll
          for (int k = 0; k < GWORDS; ++k) {
            for (int c8 = 0; c8 < 32 / QPC; ++c8) {
              const int c = (32 / QPC) * k + c8;
              if (c >= cpp) break;
              const int chunk = p * cpp + c;
              if (!enters(r.o, r.d, r.inv, cab + (size_t)chunk * 6, tp)) continue;
              ++chunks_n;
#pragma unroll
              for (int q = 0; q < QPC; ++q) {
                if (enters(r.o, r.d, r.inv, qab + ((size_t)chunk * QPC + q) * 6, tp)) {
                  gm[k] |= 1u << (QPC * c8 + q);
                  ++groups_n;
                }
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < GWORDS; ++k) {
          const unsigned v = __reduce_or_sync(0xffffffffu, gm[k]);
          if (lane == 0 && v != 0u) atomicOr(&sh.gmask[p][k], v);
        }
        if (!__syncthreads_or(CLOSEST ? r.valid : r.valid && !occ)) {
          done = true;
          break;
        }
        settle();
        // stage each entered group in ascending index; only the lanes that
        // want it list their rays
        for (int k = 0; k < GWORDS && !done; ++k) {
          const unsigned mk = k == 0 ? gm[0] : k == 1 ? gm[1] : k == 2 ? gm[2] : gm[3];
          for (unsigned m = sh.gmask[p][k]; m; m &= m - 1) {
            const int b = __ffs(m) - 1;
            const int g = p * gpp + 32 * k + b;
            bool want = (mk >> b) & 1u;
            if constexpr (CLOSEST) {
              want = want && enters(r.o, r.d, r.inv, qab + (size_t)g * 6, fminf(best, r.tl));
            } else {
              want = want && !occ;
            }
            const unsigned bal = __ballot_sync(0xffffffffu, want);
            if (want) {
              Entry& en = sh.list[buf][warp][__popc(bal & ((1u << lane) - 1u))];
              en.o = make_float4(r.o[0], r.o[1], r.o[2], CLOSEST ? fminf(best, r.tl) : r.tl);
              en.d = make_float4(r.d[0], r.d[1], r.d[2], __int_as_float(tid));
              if constexpr (CLOSEST) sh.key[buf][tid] = NO_KEY;
            }
            if (lane == 0) sh.cnt[buf][warp] = __popc(bal);
            // this thread's row of the group, into registers
            const int row = g * QH + tid;
            const float4* src = reinterpret_cast<const float4*>(aux + (size_t)row * AUX_COLS);
            const float4 pa = src[0], pb = src[1], pc = src[2];
            // any hit: the valid lanes not known occluded (a lane hit by
            // another thread since its last read still counts: high, never
            // low)
            const int open_n = __syncthreads_count(CLOSEST ? want : r.valid && !occ);
            if constexpr (CLOSEST) {
              settle();  // the previous staged group's tests are done
              if (want) pend = buf;
            } else if (open_n == 0) {
              done = true;
              break;
            }
            int listed = 0;
#pragma unroll
            for (int lw = 0; lw < WARPS; ++lw) listed += sh.cnt[buf][lw];
            if (listed > 0) {
              ++staged;
              listed_n += listed;
              // thread tid tests row tid against every listed lane: the
              // least t, then the lowest row, of this group into the lane's
              // key (t > 0, so its bits order as the floats), or the lane's
              // occluded flag
              for (int lw = 0; lw < WARPS; ++lw) {
                const int cnt = sh.cnt[buf][lw];
                for (int i = 0; i < cnt; ++i) {
                  const Entry& en = sh.list[buf][lw][i];
                  const int who = __float_as_int(en.d.w);
                  if constexpr (!CLOSEST) {
                    if (occs[who]) continue;
                  }
                  ++pairs;
                  const Terms q =
                      terms(en.o.x, en.o.y, en.o.z, en.d.x, en.d.y, en.d.z, pa, pb, pc);
                  if constexpr (CLOSEST) {
                    float t;
                    if (closest_pair(q, en.o.w, t)) {
                      atomicMin(&sh.key[buf][who],
                                ((unsigned long long)__float_as_uint(t) << 32) | (unsigned)row);
                    }
                  } else {
                    if (shadow_pair(q, en.o.w)) occs[who] = 1;
                  }
                }
              }
            }
            // any hit: later hits by other threads show at the next read
            if constexpr (!CLOSEST) occ = occs[tid] != 0;
            buf ^= 1;
          }
        }
      }
    }
  }
  __syncthreads();
  settle();

  if (stats != nullptr && live > 0) {
    parts_n = warp_sum(parts_n);
    chunks_n = warp_sum(chunks_n);
    groups_n = warp_sum(groups_n);
    pairs = warp_sum(pairs);
    if (lane == 0) {
      atomicAdd(stats + 2, groups_n);
      atomicAdd(stats + 5, pairs);
      atomicAdd(stats + 6, parts_n);
      atomicAdd(stats + 7, chunks_n);
    }
    if (tid == 0) {
      atomicAdd(stats, 1ull);
      atomicAdd(stats + 1, (unsigned long long)live);
      atomicAdd(stats + 3, staged);
      atomicAdd(stats + 4, listed_n);
    }
  }
  const int ray = blockIdx.x * SBLK + tid;
  if (ray >= n) return;
  if constexpr (CLOSEST) {
    out_t[ray] = best;
    out_idx[ray] = best_row;
  } else {
    out_any[ray] = occs[tid] != 0 ? 1 : 0;
  }
}

__global__ void __launch_bounds__(SBLK)
stream_closest_kernel(const float* __restrict__ aux, const float* __restrict__ cab,
                      const float* __restrict__ pab, const float* __restrict__ qab, int nparts,
                      int cpp, const float* __restrict__ orig,
                      const float* __restrict__ dir, const float* __restrict__ tlim, int n,
                      float* __restrict__ out_t, int* __restrict__ out_idx,
                      unsigned long long* __restrict__ stats) {
  stream_walk<true>(aux, cab, pab, qab, nparts, cpp, orig, dir, tlim, n, out_t, out_idx,
                    nullptr, stats);
}

// Shadow test (_stream_any_kernel): shadow_pair over the staged groups,
// each lane until it is occluded, the block until every valid lane is.
__global__ void __launch_bounds__(SBLK)
stream_any_kernel(const float* __restrict__ aux, const float* __restrict__ cab,
                  const float* __restrict__ pab, const float* __restrict__ qab, int nparts,
                  int cpp, const float* __restrict__ orig,
                  const float* __restrict__ dir, const float* __restrict__ tlim, int n,
                  uint8_t* __restrict__ out, unsigned long long* __restrict__ stats) {
  stream_walk<false>(aux, cab, pab, qab, nparts, cpp, orig, dir, tlim, n, nullptr,
                     nullptr, out, stats);
}

bool bad_table(int nparts, int cpp) {
  return nparts < 1 || nparts > MAX_PARTS || cpp < 1 || cpp > MAX_CPP;
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; the stream
// is the caller's cudaStream_t. Each returns cudaGetLastError() after the
// launch (0 = success; a table outside the kernels' sizes is
// cudaErrorInvalidValue); nothing synchronises. ``stats`` may be null.
extern "C" int stream_closest(int device, const float* aux, const float* cab, const float* pab,
                              const float* qab, int nparts, int cpp, const float* orig,
                              const float* dir, const float* tlim, int n, float* out_t,
                              int* out_idx, unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_table(nparts, cpp)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    stream_closest_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(
        aux, cab, pab, qab, nparts, cpp, orig, dir, tlim, n, out_t, out_idx, stats);
  }
  return (int)cudaGetLastError();
}

extern "C" int stream_any(int device, const float* aux, const float* cab, const float* pab,
                          const float* qab, int nparts, int cpp, const float* orig,
                          const float* dir, const float* tlim, int n, uint8_t* out,
                          unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_table(nparts, cpp)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    stream_any_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(
        aux, cab, pab, qab, nparts, cpp, orig, dir, tlim, n, out, stats);
  }
  return (int)cudaGetLastError();
}
