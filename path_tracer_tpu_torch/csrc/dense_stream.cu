// Streamed dense closest-hit and any-hit over one table of up to 2M
// triangles, for Hopper: the world queries of a baked soup above 16,384
// triangles when the walk is switched off (PT_WALK=0, Scene.device(...,
// engine="stream")).
//
// Replaces path_tracer_tpu/trace/dense_stream.py::_stream_closest_kernel and
// ::_stream_any_kernel (contract: dense_stream_closest_hit_shade /
// dense_stream_any_hit there). The TPU kernels double-buffer part tables
// through VMEM and keep every ray block's state resident; here device memory
// holds the table and each ray block walks it on its own.
//
// Tables (trace/dense_stream.py pack_dense_stream):
//   aux [nparts*cpp*512, 24] f32, one row per triangle in the soup's order,
//       fixed-stride padded (row index == soup index; pad rows are zero and
//       never hit): cols 0-3 n0.xyz d0 | 4-7 n1.xyz d1 | 8-11 n2.xyz d2 | ...
//   cab [nparts*cpp, 6] f32, chunk boxes (lo xyz | hi xyz) of 512 rows each;
//       pad chunks carry inverted boxes
//   pab [nparts, 6] f32, part boxes (cpp <= 32 chunks per part)
// Rays arrive in the caller's order, t_limit clamped finite; the wrapper
// checks shapes and types.
//
// Design. One block of 128 threads per block of 128 rays, one ray per
// thread. Invalid lanes (t_limit <= 0 or a non-finite origin/direction) are
// zeroed with t_limit 0, as dense_stream._pack_rays_t does, and left out of
// the block's conservative ray bounds (_bounds_rows: one NaN lane must not
// cull a live block). The block walks the parts in order: a part whose box
// fails the block gate (_gate's slab arithmetic and slack against the
// block's window) is skipped; otherwise one thread per chunk gates the
// part's chunk boxes and a warp ballot gives the survivors in ascending
// order. Before a surviving chunk is staged, every lane runs its own slab
// test (segment.cuh enters, shared with the walk any-hits) against the
// chunk box within its own window (closest: min(best,
// t_limit); any hit: t_limit while unoccluded); a chunk no lane enters is
// skipped (an exact skip: the box holds every triangle of the chunk, padded).
// Otherwise the block stages the chunk's 512 plane rows (three float4 each)
// into shared memory and the lanes that entered it test all of them with
// dense_hit.cu's pair test (dense_common.cuh). The window, the max over
// live lanes of min(best, t_limit) (any hit: of the unoccluded lanes'
// t_limit), shrinks after every staged chunk, not only after every part as
// on the TPU; chunks are visited in ascending index and a nearer hit must be
// strictly nearer, so the lowest soup index still wins ties. The any-hit
// block leaves once every live lane is occluded.
//
// What bounds it: FP32 ALU per tested ray x triangle pair (closest 47 ops,
// any 46, as in dense_hit.cu). Diffuse bounce blocks cross 0 on every
// direction axis, where the block gate admits every chunk; the per-lane
// chunk test is what keeps such a block from testing the whole table.
//
// Counters. With a non-null ``stats`` ([5] u64, zeroed by the caller) each
// block with a live lane adds 1 to stats[0], the parts it admits to
// stats[1], the chunks that pass its gate and window to stats[2], the chunks
// it stages to stats[3], and the lanes testing a staged chunk to stats[4].
// Off (null) on the main path.
//
// Floating point. Built with -fmad=false (trace/cuda_lib.py): the candidate
// t is dense_hit.cu's (1/det plus one Newton step), so best t and the winner
// equal the plain torch version's (trace/dense_stream.py) bit for bit.

#include "dense_common.cuh"
#include "segment.cuh"

namespace {

constexpr int SBLK = 128;  // rays per block (dense_stream.py SBLK)
constexpr int CH = 512;    // triangles per chunk (dense_stream.py CH)
constexpr int MAX_CPP = 32;  // chunks per part: PART_TRIS / CH
constexpr int WARPS = SBLK / 32;
constexpr float T_CLAMP = 3.0e38f;  // finite stand-in for an infinite t_limit

struct Ray {
  float o[3], d[3], inv[3];
  float tl;
  bool valid;
};

// Conservative bounds of the block's valid lanes (_bounds_rows).
struct Bounds {
  float olo[3], ohi[3], dlo[3], dhi[3];
  float tmax;
  int anyv;
};

struct Shared {
  float4 planes[3 * CH];  // n0|d0, n1|d1, n2|d2 of the staged chunk
  float box[MAX_CPP][6];  // the part's chunk boxes
  float te[MAX_CPP];      // their gate entry t
  float th[MAX_CPP];      // and exit t, before the window
  float red[WARPS][13];
  float win[WARPS];
  unsigned bits;
  Bounds bb;
};

// Load this thread's ray; invalid lanes are zeroed with t_limit 0.
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

// Block-wide bounds into sh.bb; every thread returns after the barrier that
// publishes them.
__device__ void block_bounds(const Ray& r, Shared& sh) {
  // olo xyz (min) | ohi xyz (max) | dlo xyz (min) | dhi xyz (max) | tmax (max)
  float v[13];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v[a] = r.valid ? r.o[a] : BIG;
    v[3 + a] = r.valid ? r.o[a] : -BIG;
    v[6 + a] = r.valid ? r.d[a] : BIG;
    v[9 + a] = r.valid ? r.d[a] : -BIG;
  }
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
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < 13; ++i) sh.red[threadIdx.x / 32][i] = v[i];
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
      b.olo[a] = t[a];
      b.ohi[a] = t[3 + a];
      b.dlo[a] = t[6 + a];
      b.dhi[a] = t[9 + a];
    }
    b.tmax = t[12];
  }
  __syncthreads();
}

// _gate's conservative slab test of ``box`` (lo xyz | hi xyz) against the
// block's bounds: entry t_lo and exit t_hi before the window.
__device__ __forceinline__ void slab(const Bounds& b, const float* box, float& t_lo,
                                     float& t_hi) {
  t_lo = 0.0f;
  t_hi = BIG;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float nlo = box[k] - b.ohi[k];
    const float nhi = box[3 + k] - b.olo[k];
    const float dl = b.dlo[k], dh = b.dhi[k];
    const bool crosses = dl <= 0.0f && dh >= 0.0f;
    const float sl = dl == 0.0f ? 1.0f : dl;
    const float sh = dh == 0.0f ? 1.0f : dh;
    const float c0 = nlo / sl, c1 = nlo / sh, c2 = nhi / sl, c3 = nhi / sh;
    const float lo = fminf(fminf(c0, c1), fminf(c2, c3));
    const float hi = fmaxf(fmaxf(c0, c1), fmaxf(c2, c3));
    t_lo = fmaxf(t_lo, crosses ? -BIG : lo);
    t_hi = fminf(t_hi, crosses ? BIG : hi);
  }
}

// The gate against the window: t_hi is capped at win*1.00002 + 1e-5.
__device__ __forceinline__ bool admits(float t_lo, float t_hi, float win) {
  return t_lo <= fminf(t_hi, win * WIN_MUL + WIN_ADD);
}

// Gate part p's chunk boxes (one thread each, warp 0) against the window:
// boxes, entry and exit t into shared memory, survivors into sh.bits (bit =
// chunk within the part). Starts and ends with a barrier.
__device__ void gate_part(const float* __restrict__ cab, int p, int cpp, float win, Shared& sh) {
  __syncthreads();  // the previous part's entries are consumed
  if (threadIdx.x < 32) {
    const int c = threadIdx.x;
    bool ok = false;
    if (c < cpp) {
      const float* src = cab + (size_t)(p * cpp + c) * 6;
#pragma unroll
      for (int k = 0; k < 6; ++k) sh.box[c][k] = src[k];
      float t_lo, t_hi;
      slab(sh.bb, sh.box[c], t_lo, t_hi);
      sh.te[c] = t_lo;
      sh.th[c] = t_hi;
      ok = admits(t_lo, t_hi, win);
    }
    const unsigned bits = __ballot_sync(0xffffffffu, ok);
    if (c == 0) sh.bits = bits;
  }
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

struct Counters {
  unsigned long long parts, gated, staged, lanes;
};

__device__ __forceinline__ void count(unsigned long long* stats, int anyv, const Counters& c) {
  if (stats != nullptr && threadIdx.x == 0 && anyv) {
    atomicAdd(stats, 1ull);
    atomicAdd(stats + 1, c.parts);
    atomicAdd(stats + 2, c.gated);
    atomicAdd(stats + 3, c.staged);
    atomicAdd(stats + 4, c.lanes);
  }
}

__global__ void __launch_bounds__(SBLK)
stream_closest_kernel(const float* __restrict__ aux, const float* __restrict__ cab,
                      const float* __restrict__ pab, int nparts, int cpp,
                      const float* __restrict__ orig, const float* __restrict__ dir,
                      const float* __restrict__ tlim, int n, float* __restrict__ out_t,
                      int* __restrict__ out_idx, unsigned long long* __restrict__ stats) {
  __shared__ Shared sh;
  const Ray r = load_ray(orig, dir, tlim, n);
  block_bounds(r, sh);
  const int n_rows = nparts * cpp * CH;

  float best = BIG;
  int idx = -1;
  Counters cn = {};
  if (sh.bb.anyv) {
    float win = sh.bb.tmax;  // uniform across the block
    for (int p = 0; p < nparts; ++p) {
      float t_lo, t_hi;
      slab(sh.bb, pab + (size_t)p * 6, t_lo, t_hi);
      if (!admits(t_lo, t_hi, win)) continue;
      ++cn.parts;
      gate_part(cab, p, cpp, win, sh);
      for (unsigned m = sh.bits; m; m &= m - 1) {
        const int c = __ffs(m) - 1;
        if (!admits(sh.te[c], sh.th[c], win)) continue;
        ++cn.gated;
        const bool want = r.valid && enters(r.o, r.d, r.inv, sh.box[c], fminf(best, r.tl));
        const int lanes = __syncthreads_count(want);
        if (lanes == 0) continue;
        ++cn.staged;
        cn.lanes += lanes;
        const int base = (p * cpp + c) * CH;
        load_rows<CH>(aux, n_rows, base, sh.planes);
        __syncthreads();
        if (want) {
          for (int j = 0; j < CH; ++j) {
            const Terms q = terms(r.o[0], r.o[1], r.o[2], r.d[0], r.d[1], r.d[2], sh.planes[j],
                                  sh.planes[CH + j], sh.planes[2 * CH + j]);
            float t;
            // strict <: the lowest soup index wins ties
            if (closest_pair(q, r.tl, t) && t < best) {
              best = t;
              idx = base + j;
            }
          }
        }
        win = fminf(win, block_max(fminf(best, r.tl), sh));
      }
    }
  }
  const int ray = blockIdx.x * SBLK + threadIdx.x;
  if (ray < n) {
    out_t[ray] = best;
    out_idx[ray] = idx;
  }
  count(stats, sh.bb.anyv, cn);
}

// Shadow test (_stream_any_kernel): shadow_pair over the staged chunks,
// each lane until it is occluded, the block until every live lane is.
__global__ void __launch_bounds__(SBLK)
stream_any_kernel(const float* __restrict__ aux, const float* __restrict__ cab,
                  const float* __restrict__ pab, int nparts, int cpp,
                  const float* __restrict__ orig, const float* __restrict__ dir,
                  const float* __restrict__ tlim, int n, uint8_t* __restrict__ out,
                  unsigned long long* __restrict__ stats) {
  __shared__ Shared sh;
  const Ray r = load_ray(orig, dir, tlim, n);
  block_bounds(r, sh);
  const int n_rows = nparts * cpp * CH;

  bool occ = false;
  Counters cn = {};
  if (sh.bb.anyv) {
    float win = sh.bb.tmax;  // uniform; 0 once every live lane is occluded
    for (int p = 0; p < nparts && win > 0.0f; ++p) {
      float t_lo, t_hi;
      slab(sh.bb, pab + (size_t)p * 6, t_lo, t_hi);
      if (!admits(t_lo, t_hi, win)) continue;
      ++cn.parts;
      gate_part(cab, p, cpp, win, sh);
      for (unsigned m = sh.bits; m && win > 0.0f; m &= m - 1) {
        const int c = __ffs(m) - 1;
        if (!admits(sh.te[c], sh.th[c], win)) continue;
        ++cn.gated;
        const bool want = r.valid && !occ && enters(r.o, r.d, r.inv, sh.box[c], r.tl);
        const int lanes = __syncthreads_count(want);
        if (lanes == 0) continue;
        ++cn.staged;
        cn.lanes += lanes;
        const int base = (p * cpp + c) * CH;
        load_rows<CH>(aux, n_rows, base, sh.planes);
        __syncthreads();
        if (want) {
          for (int j = 0; j < CH; ++j) {
            if (shadow_pair(terms(r.o[0], r.o[1], r.o[2], r.d[0], r.d[1], r.d[2], sh.planes[j],
                                  sh.planes[CH + j], sh.planes[2 * CH + j]),
                            r.tl)) {
              occ = true;
              break;
            }
          }
        }
        win = fminf(win, block_max(occ ? 0.0f : r.tl, sh));
      }
    }
  }
  const int ray = blockIdx.x * SBLK + threadIdx.x;
  if (ray < n) out[ray] = occ ? 1 : 0;
  count(stats, sh.bb.anyv, cn);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; the stream
// is the caller's cudaStream_t. Each returns cudaGetLastError() after the
// launch (0 = success); nothing synchronises. ``stats`` may be null.
extern "C" int stream_closest(int device, const float* aux, const float* cab, const float* pab,
                              int nparts, int cpp, const float* orig, const float* dir,
                              const float* tlim, int n, float* out_t, int* out_idx,
                              unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cpp < 1 || cpp > MAX_CPP) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    stream_closest_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(
        aux, cab, pab, nparts, cpp, orig, dir, tlim, n, out_t, out_idx, stats);
  }
  return (int)cudaGetLastError();
}

extern "C" int stream_any(int device, const float* aux, const float* cab, const float* pab,
                          int nparts, int cpp, const float* orig, const float* dir,
                          const float* tlim, int n, uint8_t* out, unsigned long long* stats,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cpp < 1 || cpp > MAX_CPP) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    stream_any_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(
        aux, cab, pab, nparts, cpp, orig, dir, tlim, n, out, stats);
  }
  return (int)cudaGetLastError();
}
