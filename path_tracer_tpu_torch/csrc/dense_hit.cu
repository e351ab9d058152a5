// Dense closest-hit and any-hit over one <=16K-triangle table, for Hopper.
//
// Replaces path_tracer_tpu/trace/dense_pallas.py::_closest_kernel (closest
// hit + fused shading fetch) and ::_any_kernel (NEE shadow test). The
// contract is dense_pl_closest_hit_shade / dense_pl_any_hit there; the
// TPU's chunk-interleaved MXU weight table W is not carried over. Both
// kernels read the triangle-major aux table [T, 24] f32, one row per
// triangle and no pad rows:
//   cols 0-3 n0.xyz d0 | 4-7 n1.xyz d1 | 8-11 n2.xyz d2 | 12-20 vertex
//   normals na nb nc | 21 model id | 22-23 pad
//
// Design. One thread per ray, 128 rays per block. The block stages TILE
// triangles' plane rows (the first 12 floats, three float4) through shared
// memory and every thread tests its ray against the whole tile; all threads
// read the same shared word at once (a broadcast, no bank conflicts). Work
// is bound by FP32 ALU: ~46 flops per ray x triangle pair in the search
// (det 5, td 6, ud and vd 14 each, the sign-test differences, a reciprocal
// and one Newton step; about 20 if products and sums fused into FMAs), at
// ~0.6M rays x 5,132 tris ~ 3e9 pairs per closest query at 1024x576.
// Staging the table through shared memory keeps
// the loads off that path: each plane row is read from L2 once per block
// and then feeds 128 rays. There is no chunk-AABB gate and no live
// t-window (the TPU kernel's culling): every ray tests every triangle, which
// gives the unculled answer. Culling is the first perf step of a later
// change. The only skip is exact: a block whose rays all have t_limit <= 0
// (dead lanes) returns at once, and the any-hit block stops once every ray
// in it is resolved. The staging and the pair tests live in
// dense_common.cuh, shared with the streamed engine (dense_stream.cu).
//
// Floating point. Built with -fmad=false and without --use_fast_math: every
// product and sum is rounded on its own, in the order written below, which
// is the order of the plain torch version in trace/dense_cuda.py (torch
// evaluates each elementwise op separately). So kernel and plain version
// agree bit for bit on the winner and on t/u/v. The search takes t from
// 1/det plus one Newton step, as the TPU kernel does; the epilogue
// recomputes the winner's t/u/v with a true reciprocal in
// traversal._tri_intersect order.

#include "dense_common.cuh"

namespace {

constexpr int THREADS = 128;  // rays per block
constexpr int TILE = 128;     // triangles per shared-memory tile

__global__ void __launch_bounds__(THREADS)
closest_kernel(const float* __restrict__ aux, int n_tris,
               const float* __restrict__ orig, const float* __restrict__ dir,
               const float* __restrict__ tlim, int n, float* __restrict__ out) {
  __shared__ float4 sh[3 * TILE];
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = ray < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, tl = 0.f;
  if (active) {
    ox = orig[3 * ray];
    oy = orig[3 * ray + 1];
    oz = orig[3 * ray + 2];
    dx = dir[3 * ray];
    dy = dir[3 * ray + 1];
    dz = dir[3 * ray + 2];
    tl = tlim[ray];
  }
  // t_limit <= 0 (or NaN) accepts no t > EPS: such a ray cannot hit.
  const bool live = active && tl > 0.0f;

  float best_t = BIG;
  int best = -1;
  if (__syncthreads_or(live)) {
    for (int base = 0; base < n_tris; base += TILE) {
      load_rows<TILE>(aux, n_tris, base, sh);
      __syncthreads();
      if (live) {
        const int cnt = min(TILE, n_tris - base);
        for (int j = 0; j < cnt; ++j) {
          const Terms q = terms(ox, oy, oz, dx, dy, dz, sh[j], sh[TILE + j], sh[2 * TILE + j]);
          float t;
          // strict <: the lowest table index wins ties
          if (closest_pair(q, tl, t) && t < best_t) {
            best_t = t;
            best = base + j;
          }
        }
      }
      __syncthreads();
    }
  }
  if (!active) return;

  // Epilogue: the winner's exact t/u/v in traversal._tri_intersect order,
  // its unnormalised barycentric normal and its model id. A miss reads an
  // all-zero row, as the TPU kernel's one-hot fetch does.
  float row[AUX_COLS];
  if (best >= 0) {
    const float4* src = reinterpret_cast<const float4*>(aux + (size_t)best * AUX_COLS);
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
  const float det = row[0] * dx + row[1] * dy + row[2] * dz;
  const float td = row[3] - (row[0] * ox + row[1] * oy + row[2] * oz);
  const float px = det * ox + td * dx;
  const float py = det * oy + td * dy;
  const float pz = det * oz + td * dz;
  const float ud = row[4] * px + row[5] * py + row[6] * pz + det * row[7];
  const float vd = row[8] * px + row[9] * py + row[10] * pz + det * row[11];
  const float inv = 1.0f / (det == 0.0f ? 1.0f : det);
  const float t = td * inv;
  const float u = ud * inv;
  const float v = vd * inv;
  const float w = 1.0f - u - v;
  float* o8 = out + (size_t)ray * 8;
  o8[0] = t;
  o8[1] = (float)best;
  o8[2] = u;
  o8[3] = v;
  o8[4] = w * row[12] + u * row[15] + v * row[18];
  o8[5] = w * row[13] + u * row[16] + v * row[19];
  o8[6] = w * row[14] + u * row[17] + v * row[20];
  o8[7] = row[21];
}

// Shadow test, division-free: hit iff sign(td - det*eps) == sign(det*tlim - td)
// plus the two barycentric sign tests. Rays with t_limit <= 0 or a
// non-finite origin/direction report no hit and count as resolved.
__global__ void __launch_bounds__(THREADS)
any_kernel(const float* __restrict__ aux, int n_tris,
           const float* __restrict__ orig, const float* __restrict__ dir,
           const float* __restrict__ tlim, int n, uint8_t* __restrict__ out) {
  __shared__ float4 sh[3 * TILE];
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = ray < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, tl = 0.f;
  if (active) {
    ox = orig[3 * ray];
    oy = orig[3 * ray + 1];
    oz = orig[3 * ray + 2];
    dx = dir[3 * ray];
    dy = dir[3 * ray + 1];
    dz = dir[3 * ray + 2];
    tl = tlim[ray];
  }
  const bool valid = active && tl > 0.0f && isfinite(ox) && isfinite(oy) &&
                     isfinite(oz) && isfinite(dx) && isfinite(dy) && isfinite(dz);
  bool found = false;
  for (int base = 0; base < n_tris; base += TILE) {
    // block exit once every ray of the block is resolved
    if (!__syncthreads_or(valid && !found)) break;
    load_rows<TILE>(aux, n_tris, base, sh);
    __syncthreads();
    if (valid && !found) {
      const int cnt = min(TILE, n_tris - base);
      for (int j = 0; j < cnt; ++j) {
        if (shadow_pair(terms(ox, oy, oz, dx, dy, dz, sh[j], sh[TILE + j], sh[2 * TILE + j]), tl)) {
          found = true;
          break;
        }
      }
    }
    __syncthreads();
  }
  if (active) out[ray] = found ? 1 : 0;
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; the stream
// is the caller's cudaStream_t. Each returns cudaGetLastError() after the
// launch (0 = success); nothing synchronises.
extern "C" int dense_closest(int device, const float* aux, int n_tris,
                             const float* orig, const float* dir,
                             const float* tlim, int n, float* out,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    closest_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(aux, n_tris, orig, dir, tlim, n, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int dense_any(int device, const float* aux, int n_tris,
                         const float* orig, const float* dir,
                         const float* tlim, int n, uint8_t* out,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    any_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(aux, n_tris, orig, dir, tlim, n, out);
  }
  return (int)cudaGetLastError();
}
