// The two gather probes, for Hopper: can a per-ray traversal afford random
// fetches of table rows, or of entries of a table tile held on chip?
//
// Replaces, as the same measurements on the card:
//   row_gather_kernel  <- benches/pallas_gather_probe.py::pallas_gather
//       (table[idx] of 128-float rows through a pipeline of row DMAs)
//   tile_gather_kernel <- benches/pallas_lane_gather_probe.py::_kern
//       (per-lane take_along_axis from a VMEM-resident tile, `reps` times)
//
// row_gather_kernel. out[r, :] = table[idx[r], :] for [M, 128] f32 rows.
// Each warp owns rows r = warp, warp + warps, ... and keeps STAGES of them
// in flight: one 16-byte cp.async per lane fills a 512-byte slot of shared
// memory, cp.async.wait_group releases the oldest, and the warp writes it
// out while the next rows are on their way (the TPU probe's BUFS-deep
// pipeline of row DMAs). Bound: bytes, each row read once and written once
// (1,028 B per index with the index itself).
//
// tile_gather_kernel. The probe's two modes over arrays x, idx, out of one
// shape, as "tables" of L entries each: element e of table t sits at
// t*st + e*se. Mode 0 (out[i,j] = x[idx[i,j], j], x [M, 128]): a table is a
// column (st = 1, se = 128, L = M). Mode 1 (out[i,j] = x[i, idx[i,j]],
// x [8, M]): a table is a row (st = M, se = 1, L = M). A block stages tb
// whole tables into shared memory (tb * L floats), then every thread reads
// its elements' indices and sums ``reps`` entries of its table, entry
// (index + k) mod L for k < reps, in the probe's order (acc = 0 + a_0 +
// a_1 ...; the TPU probe wraps once, the same where L >= reps).
// Bound: bytes, x, idx and out each moved once.
//
// Built with -fmad=false (trace/cuda_lib.py): the sums equal the plain torch
// versions' (probes/gather.py) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_W = 128;  // floats per row
constexpr int STAGES = 4;   // rows in flight per warp
constexpr int ROW_WARPS = 8;  // warps per block
constexpr int TILE_THREADS = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(ROW_WARPS * 32)
row_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx, int n,
                  float* __restrict__ out) {
  __shared__ float4 buf[ROW_WARPS][STAGES][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int first = blockIdx.x * ROW_WARPS + w, stride = gridDim.x * ROW_WARPS;
  // Each lane copies and reads back only its own 16 bytes of a slot, so the
  // wait on its own copy groups is all the ordering it needs.
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    const int r = first + s * stride;
    if (r < n) cp_async16(&buf[w][s][lane], table + (size_t)idx[r] * ROW_W + lane * 4);
    cp_async_commit();  // one group per stage, empty or not
  }
  for (int k = 0;; ++k) {
    const int r = first + k * stride;
    if (r >= n) break;
    cp_async_wait<STAGES - 1>();  // row k's group has landed
    const int s = k % STAGES;
    // the slot is read (and its value stored) before the next copy into it
    // is issued
    reinterpret_cast<float4*>(out + (size_t)r * ROW_W)[lane] = buf[w][s][lane];
    const int r2 = r + STAGES * stride;
    if (r2 < n) cp_async16(&buf[w][s][lane], table + (size_t)idx[r2] * ROW_W + lane * 4);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(TILE_THREADS)
tile_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx, int n_tables, int len,
                   int st, int se, int tb, int reps, float* __restrict__ out) {
  extern __shared__ float tab[];  // tb tables of len entries
  const int t0 = blockIdx.x * tb;
  const int nt = min(tb, n_tables - t0);
  const int count = nt * len;
  // (table, entry) of flat position k, neighbouring k on neighbouring
  // addresses: entries run fastest when they are contiguous (se == 1),
  // tables otherwise
  auto at = [&](int k, int& lt, int& e) {
    if (se == 1) {
      lt = k / len;
      e = k - lt * len;
    } else {
      e = k / nt;
      lt = k - e * nt;
    }
  };
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    int lt, e;
    at(k, lt, e);
    tab[lt * len + e] = x[(size_t)(t0 + lt) * st + (size_t)e * se];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    int lt, e;
    at(k, lt, e);
    const size_t a = (size_t)(t0 + lt) * st + (size_t)e * se;
    const int q = idx[a];
    float acc = 0.0f;
    int ik = q;  // q + j mod len
    for (int j = 0; j < reps; ++j) {
      acc = acc + tab[lt * len + ik];
      ik = ik + 1 == len ? 0 : ik + 1;
    }
    out[a] = acc;
  }
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; the stream
// is the caller's cudaStream_t. Each returns cudaGetLastError() after the
// launch (0 = success); nothing synchronises. Indices must lie in range.
extern "C" int row_gather(int device, const float* table, const int* idx, int n, float* out,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    // about STAGES rows per warp
    const int per_block = ROW_WARPS * STAGES;
    const int blocks = (n + per_block - 1) / per_block;
    row_gather_kernel<<<blocks, ROW_WARPS * 32, 0, (cudaStream_t)stream>>>(table, idx, n, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int tile_gather(int device, const float* x, const int* idx, int n_tables, int len,
                           int st, int se, int tb, int reps, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tables > 0 && len > 0) {
    const int blocks = (n_tables + tb - 1) / tb;
    const size_t shmem = (size_t)tb * len * sizeof(float);
    tile_gather_kernel<<<blocks, TILE_THREADS, shmem, (cudaStream_t)stream>>>(
        x, idx, n_tables, len, st, se, tb, reps, out);
  }
  return (int)cudaGetLastError();
}
