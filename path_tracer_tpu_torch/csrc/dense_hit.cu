// Dense closest-hit and any-hit over one <=16K-triangle table, for Hopper.
//
// Replaces path_tracer_tpu/trace/dense_pallas.py::_closest_kernel (closest
// hit + fused shading fetch) and ::_any_kernel (NEE shadow test). The
// contract is dense_pl_closest_hit_shade / dense_pl_any_hit there; the
// TPU's chunk-interleaved MXU weight table W is not carried over. Tables
// (trace/dense_cuda.py pack_dense_aux, pack_dense_cab):
//   aux [T, 24] f32, one row per triangle and no pad rows:
//       cols 0-3 n0.xyz d0 | 4-7 n1.xyz d1 | 8-11 n2.xyz d2 | 12-20 vertex
//       normals na nb nc | 21 model id | 22-23 pad
//   cab [ceil(T/128), 6] f32, the boxes (lo xyz | hi xyz) of the chunks of
//       128 consecutive rows, padded by 1e-4 * max|position| + 1e-6
//
// Design. One block of 128 threads per block of 128 rays, one ray per
// thread; the block holds every chunk box in shared memory (at most 128).
// Invalid lanes (t_limit <= 0 or a non-finite origin/direction) never hit
// and take no part. The chunks are visited in ascending index, a warp word
// of 32 at a time. Each open lane (closest: every valid one; any hit: the
// valid unoccluded ones) runs its own slab test (segment.cuh enters, shared
// with the walks and the stream) against every box of the word within its
// own window: closest, min(best, t_limit); any hit, t_limit. The masks are
// ORed block-wide behind one barrier, and a chunk that no lane enters is
// neither staged nor tested (an exact skip: the padded box holds every
// triangle of the chunk). For each entered chunk, the lanes that want it
// (closest: those that still enter it within their window, which may have
// fallen since the word's test) list their rays in shared memory, and each
// of the 128 threads takes one row of the chunk into registers and tests it
// against every listed ray: the (lane, row) pairs are spread over all
// threads, none idle because its own lane did not enter (walk_common.cuh
// lane_walk does the same over the walk's chunks). A partial chunk (the
// table's last; a light table of a few rows is one) is staged in shared
// memory instead, and its (listed lane, row) pairs are dealt out to all
// 128 threads in turn, so that a 2-row table does not leave 126 threads
// idle. One barrier per word and one per staged chunk; the rows, lists and
// keys are double-buffered so that the next chunk's listing needs no second
// barrier.
//
// The tie rule. A closest hit is merged through a 64-bit key per listed
// lane, atomicMin(float_as_uint(t) << 32 | row): t > 0, so the key ends at
// the chunk's least t, then lowest row, whatever the atomics' order. The
// lane merges its key after the next barrier with a strict < on t; chunks
// come in ascending index, so of two chunks at one t the lower keeps the
// win: the lowest table index wins a tie, as in the plain version. Until a
// key is merged the lane's window is its older, larger best: conservative,
// so the cull stays exact.
//
// The any hit flags an occluded lane in shared memory; the lane then stops
// testing, and the block leaves once every valid lane is occluded.
//
// What bounds it: FP32 ALU per tested ray x row pair (closest 47 ops, any
// 46: det 5, td 6, ud and vd 14 each, the sign-test differences, and for
// the closest hit a reciprocal and one Newton step), plus ~30 per (lane,
// chunk box) slab test. The cull cuts the pairs from every row to the rows
// of the chunks each ray's segment enters.
//
// Counters. With a non-null ``stats`` ([6] u64, zeroed by the caller) each
// block with a valid lane adds 1 to stats[0], its valid lanes to stats[1],
// the (lane, chunk) box tests that entered to stats[2], the chunks it
// stages to stats[3], the lanes listed on a staged chunk to stats[4] and
// the (lane, real row) pairs tested to stats[5]. Off (null) on the main
// path.
//
// Floating point. Built with -fmad=false and without --use_fast_math: every
// product and sum is rounded on its own, in the order written (the pair
// tests of dense_common.cuh; the epilogue below), which is the order of the
// plain torch version in trace/dense_cuda.py (torch evaluates each
// elementwise op separately). So kernel and plain version agree bit for bit
// on the winner and on t/u/v. The search takes t from 1/det plus one Newton
// step, as the TPU kernel does; the epilogue recomputes the winner's t/u/v
// with a true reciprocal in traversal._tri_intersect order.

#include "dense_common.cuh"
#include "segment.cuh"

namespace {

constexpr int SBLK = 128;        // rays per block
constexpr int CH = 128;          // rows per chunk (trace/dense_cuda.py CH)
constexpr int MAX_CHUNKS = 128;  // DENSE_MAX_TRIS / CH: one box per thread
constexpr int WARPS = SBLK / 32;
constexpr int WORDS = MAX_CHUNKS / 32;
constexpr unsigned long long NO_KEY = ~0ull;  // a listed lane without a hit

// One listed lane of a staged chunk: its ray, its window in o.w and the
// lane in d.w (int bits).
struct Entry {
  float4 o, d;
};

struct Shared {
  float4 planes[2][3 * CH];  // a partial chunk's rows: n0|d0, n1|d1, n2|d2
  Entry list[2][WARPS][32];  // each warp's listed lanes, double-buffered
  int cnt[2][WARPS];
  // closest: each listed lane's least (t bits << 32 | row) in the chunk,
  // same buffers; any hit: occluded lanes
  union {
    unsigned long long key[2][SBLK];
    int occ[SBLK];
  };
  float box[MAX_CHUNKS][6];
  unsigned mask[WORDS];  // block OR of the lanes' entered boxes, per word
};

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The walk over the table's chunks, as a closest hit (CLOSEST true: the
// [n, 8] rows of dense_closest into out_rows) or a shadow test (one flag
// per ray into out_any). The design is in the note at the top.
template <bool CLOSEST>
__device__ __forceinline__ void dense_walk(const float* __restrict__ aux,
                                           const float* __restrict__ cab, int n_tris,
                                           const float* __restrict__ orig,
                                           const float* __restrict__ dir,
                                           const float* __restrict__ tlim, int n,
                                           float* __restrict__ out_rows,
                                           uint8_t* __restrict__ out_any,
                                           unsigned long long* __restrict__ stats) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ray = blockIdx.x * SBLK + tid;
  const int chunks = (n_tris + CH - 1) / CH;
  volatile int* occs = sh.occ;

  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f}, tl = 0.f;
  if (ray < n) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = orig[3 * ray + a];
      d[a] = dir[3 * ray + a];
    }
    tl = tlim[ray];
  }
  // t_limit <= 0 (or NaN) accepts no t > EPS, and a non-finite ray meets
  // no triangle: such a lane cannot hit
  const bool valid = ray < n && tl > 0.0f && isfinite(o[0]) && isfinite(o[1]) &&
                     isfinite(o[2]) && isfinite(d[0]) && isfinite(d[1]) && isfinite(d[2]);
  const float inv[3] = {d[0] == 0.0f ? 0.0f : 1.0f / d[0], d[1] == 0.0f ? 0.0f : 1.0f / d[1],
                        d[2] == 0.0f ? 0.0f : 1.0f / d[2]};
  if constexpr (!CLOSEST) occs[tid] = 0;
  if (tid < WORDS) sh.mask[tid] = 0u;
  if (tid < chunks) {
#pragma unroll
    for (int k = 0; k < 6; ++k) sh.box[tid][k] = cab[6 * tid + k];
  }
  const int live = __syncthreads_count(valid);

  bool occ = false;                  // any hit
  float best = BIG;                  // closest: the merged winner,
  int best_row = -1;
  int pend = -1, pbase = 0;          // and the chunk whose key is not yet merged
  // closest: merge the key of the chunk this lane last listed in, once a
  // barrier has passed since its tests; strict <, so of two chunks at one
  // t the lower (visited first) keeps the win
  auto settle = [&]() {
    if constexpr (CLOSEST) {
      if (pend >= 0) {
        const unsigned long long key = sh.key[pend][tid];
        const float t = __uint_as_float((unsigned)(key >> 32));
        if (key != NO_KEY && t < best) {
          best = t;
          best_row = pbase + (int)(key & 0xffffffffu);
        }
        pend = -1;
      }
    }
  };
  unsigned long long entered_n = 0, staged = 0, listed_n = 0, pairs = 0;
  if (live > 0) {
    int buf = 0;
    for (int w = 0; w * 32 < chunks; ++w) {
      // each open lane's segment test of every box of the word within its
      // window; the masks are ORed block-wide behind one barrier
      const bool open = CLOSEST ? valid : valid && !occ;
      const float tw = CLOSEST ? fminf(best, tl) : tl;
      const int nw = min(32, chunks - 32 * w);
      unsigned mine = 0u;
      if (open) {
        for (int j = 0; j < nw; ++j) {
          if (enters(o, d, inv, sh.box[32 * w + j], tw)) mine |= 1u << j;
        }
      }
      entered_n += __popc(mine);
      const unsigned wm = __reduce_or_sync(0xffffffffu, mine);
      if (lane == 0 && wm != 0u) atomicOr(&sh.mask[w], wm);
      if (!__syncthreads_or(open)) break;  // any hit: every valid lane is occluded
      settle();
      // stage each entered chunk in ascending index; only the lanes that
      // want it list their rays
      for (unsigned m = sh.mask[w]; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const int c = 32 * w + j;
        bool want = (mine >> j) & 1u;
        if constexpr (CLOSEST) {
          want = want && enters(o, d, inv, sh.box[c], fminf(best, tl));
        } else {
          want = want && !occ;
        }
        const unsigned b = __ballot_sync(0xffffffffu, want);
        if (want) {
          Entry& en = sh.list[buf][warp][__popc(b & ((1u << lane) - 1u))];
          en.o = make_float4(o[0], o[1], o[2], CLOSEST ? fminf(best, tl) : tl);
          en.d = make_float4(d[0], d[1], d[2], __int_as_float(tid));
          if constexpr (CLOSEST) sh.key[buf][tid] = NO_KEY;
        }
        if (lane == 0) sh.cnt[buf][warp] = __popc(b);
        // this thread's row of the chunk: in registers for a full chunk,
        // in shared memory for a partial one (the table's last)
        const int rows = min(CH, n_tris - c * CH);
        const bool real = tid < rows;
        float4 pa = make_float4(0.f, 0.f, 0.f, 0.f), pb = pa, pc = pa;
        if (real) {
          const float4* src =
              reinterpret_cast<const float4*>(aux + (size_t)(c * CH + tid) * AUX_COLS);
          pa = src[0];
          pb = src[1];
          pc = src[2];
          if (rows < CH) {
            sh.planes[buf][tid] = pa;
            sh.planes[buf][CH + tid] = pb;
            sh.planes[buf][2 * CH + tid] = pc;
          }
        }
        const int listed = __syncthreads_count(want);
        if constexpr (CLOSEST) {
          settle();  // the previous staged chunk's tests are done
          if (want) {
            pend = buf;
            pbase = c * CH;
          }
        }
        ++staged;
        listed_n += listed;
        // one (listed lane, row) pair: the least t, then the lowest row, of
        // this chunk into the lane's key (t > 0, so its bits order as the
        // floats), or the lane's occluded flag
        auto test = [&](const Entry& en, float4 ra, float4 rb, float4 rc, int r) {
          const int who = __float_as_int(en.d.w);
          if constexpr (!CLOSEST) {
            if (occs[who]) return;
          }
          ++pairs;
          const Terms q = terms(en.o.x, en.o.y, en.o.z, en.d.x, en.d.y, en.d.z, ra, rb, rc);
          if constexpr (CLOSEST) {
            float t;
            if (closest_pair(q, en.o.w, t)) {
              atomicMin(&sh.key[buf][who],
                        ((unsigned long long)__float_as_uint(t) << 32) | (unsigned)r);
            }
          } else {
            if (shadow_pair(q, en.o.w)) occs[who] = 1;
          }
        };
        if (rows == CH) {
          // thread tid tests row tid against every listed lane
          for (int lw = 0; lw < WARPS; ++lw) {
            const int cnt = sh.cnt[buf][lw];
            for (int i = 0; i < cnt; ++i) test(sh.list[buf][lw][i], pa, pb, pc, tid);
          }
        } else {
          // a partial chunk: the listed x rows pairs, spread over every
          // thread in turn
          int start[WARPS + 1];
          start[0] = 0;
#pragma unroll
          for (int lw = 0; lw < WARPS; ++lw) start[lw + 1] = start[lw] + sh.cnt[buf][lw];
          const float4* pl = sh.planes[buf];
          for (int pr = tid; pr < start[WARPS] * rows; pr += SBLK) {
            const int i = pr / rows, r = pr - i * rows;
            int lw = 0, first = 0;  // the warp list that holds listed lane i
#pragma unroll
            for (int w2 = 1; w2 < WARPS; ++w2) {
              if (i >= start[w2]) {
                lw = w2;
                first = start[w2];
              }
            }
            test(sh.list[buf][lw][i - first], pl[r], pl[CH + r], pl[2 * CH + r], r);
          }
        }
        // any hit: later hits by other threads show at the next read
        if constexpr (!CLOSEST) occ = occs[tid] != 0;
        buf ^= 1;
      }
    }
  }
  __syncthreads();
  settle();

  if (stats != nullptr && live > 0) {
    entered_n = warp_sum(entered_n);
    pairs = warp_sum(pairs);
    if (lane == 0) {
      atomicAdd(stats + 2, entered_n);
      atomicAdd(stats + 5, pairs);
    }
    if (tid == 0) {
      atomicAdd(stats, 1ull);
      atomicAdd(stats + 1, (unsigned long long)live);
      atomicAdd(stats + 3, staged);
      atomicAdd(stats + 4, listed_n);
    }
  }
  if (ray >= n) return;
  if constexpr (!CLOSEST) {
    out_any[ray] = occs[tid] != 0 ? 1 : 0;
  } else {
    // Epilogue: the winner's exact t/u/v in traversal._tri_intersect order,
    // its unnormalised barycentric normal and its model id. A miss reads an
    // all-zero row, as the TPU kernel's one-hot fetch does.
    float row[AUX_COLS];
    if (best_row >= 0) {
      const float4* src = reinterpret_cast<const float4*>(aux + (size_t)best_row * AUX_COLS);
#pragma unroll
      for (int k = 0; k < AUX_COLS / 4; ++k) {
        const float4 v = src[k];
        row[4 * k] = v.x;
        row[4 * k + 1] = v.y;
        row[4 * k + 2] = v.z;
        row[4 * k + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < AUX_COLS; ++k) row[k] = 0.0f;
    }
    const float ox = o[0], oy = o[1], oz = o[2], dx = d[0], dy = d[1], dz = d[2];
    const float det = row[0] * dx + row[1] * dy + row[2] * dz;
    const float td = row[3] - (row[0] * ox + row[1] * oy + row[2] * oz);
    const float px = det * ox + td * dx;
    const float py = det * oy + td * dy;
    const float pz = det * oz + td * dz;
    const float ud = row[4] * px + row[5] * py + row[6] * pz + det * row[7];
    const float vd = row[8] * px + row[9] * py + row[10] * pz + det * row[11];
    const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
    const float t = td * inv_det;
    const float u = ud * inv_det;
    const float v = vd * inv_det;
    const float w = 1.0f - u - v;
    float* o8 = out_rows + (size_t)ray * 8;
    o8[0] = t;
    o8[1] = (float)best_row;
    o8[2] = u;
    o8[3] = v;
    o8[4] = w * row[12] + u * row[15] + v * row[18];
    o8[5] = w * row[13] + u * row[16] + v * row[19];
    o8[6] = w * row[14] + u * row[17] + v * row[20];
    o8[7] = row[21];
  }
}

__global__ void __launch_bounds__(SBLK)
closest_kernel(const float* __restrict__ aux, const float* __restrict__ cab, int n_tris,
               const float* __restrict__ orig, const float* __restrict__ dir,
               const float* __restrict__ tlim, int n, float* __restrict__ out,
               unsigned long long* __restrict__ stats) {
  dense_walk<true>(aux, cab, n_tris, orig, dir, tlim, n, out, nullptr, stats);
}

// Shadow test, division-free: hit iff sign(td - det*eps) == sign(det*tlim - td)
// plus the two barycentric sign tests (dense_common.cuh shadow_pair).
__global__ void __launch_bounds__(SBLK)
any_kernel(const float* __restrict__ aux, const float* __restrict__ cab, int n_tris,
           const float* __restrict__ orig, const float* __restrict__ dir,
           const float* __restrict__ tlim, int n, uint8_t* __restrict__ out,
           unsigned long long* __restrict__ stats) {
  dense_walk<false>(aux, cab, n_tris, orig, dir, tlim, n, nullptr, out, stats);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; ``stats``
// may be null; the stream is the caller's cudaStream_t. Each returns
// cudaGetLastError() after the launch (0 = success; a table above
// MAX_CHUNKS chunks is cudaErrorInvalidValue); nothing synchronises.
extern "C" int dense_closest(int device, const float* aux, const float* cab, int n_tris,
                             const float* orig, const float* dir, const float* tlim, int n,
                             float* out, unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tris < 0 || n_tris > MAX_CHUNKS * CH) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    closest_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(aux, cab, n_tris, orig, dir, tlim,
                                                              n, out, stats);
  }
  return (int)cudaGetLastError();
}

extern "C" int dense_any(int device, const float* aux, const float* cab, int n_tris,
                         const float* orig, const float* dir, const float* tlim, int n,
                         uint8_t* out, unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tris < 0 || n_tris > MAX_CHUNKS * CH) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    any_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(aux, cab, n_tris, orig, dir, tlim, n,
                                                          out, stats);
  }
  return (int)cudaGetLastError();
}
