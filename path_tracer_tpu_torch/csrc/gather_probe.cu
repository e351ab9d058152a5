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
// Bound: bytes, each row read once and written once (1,028 B per index with
// the index itself). A 512-B row is one 16-B vector per lane of a warp, so
// a warp moves a row per instruction, straight into registers and out
// again (no shared memory): read-only loads that skip L1, streaming stores.
// A warp takes units of ROW_U rows: lanes 0..ROW_U-1 load the unit's
// indices in one coalesced load (the next unit's while this one's rows are
// in flight) and __shfl_sync hands each lane every row's index, so no row
// waits on a load of its own index; the ROW_U row loads are issued before
// the first store, ROW_U * 512 B in flight per warp. The grid is sized
// from the SM count and the kernel's occupancy: as many warps as there are
// units, up to what the card holds at once, then a grid-stride loop. Units
// of 4 rows: on the probe's 16,384 rows on an H100, units of 8 or 16 rows
// (fewer warps, the same bytes in flight) took ~1.09x as long, 2 or 1
// rows 1.00-1.02x; write-back stores took 1.17x the streaming ones, and
// copying each warp's rows through shared memory with cp.async.bulk 1.04x
// the 16-row kernel. The time is mostly the launch itself (an empty kernel
// takes ~60% of it) and L2 traffic: the 8 MB of rows the probe reads stay
// in the 50 MB L2 from launch to launch.
//
// tile_gather_kernel. The probe's two modes over arrays x, idx, out of one
// shape [rows, cols], as "tables" of len entries each. Mode 0 (axis 0:
// out[i,j] = x[idx[i,j], j], x [M, 128]): a table is a column, len = rows.
// Mode 1 (axis 1: out[i,j] = x[i, idx[i,j]], x [8, M]): a table is a row,
// len = cols. Every thread owns quads: 4 outputs that are neighbours in
// memory (mode 0: one row's entries of 4 tables; mode 1: 4 entries of one
// table), read as one 16-B load of idx and written as one 16-B store of
// out. A block owns one group of tables (mode 0: 4 columns; mode 1: one
// row), which it stages whole into shared memory with 16-B loads (mode 0:
// each row's 4 columns as one float4, spread into 4 tables so that lanes
// reading different entries of one table hit different banks), and one
// slice of that group's quads: blockIdx.x picks the group, blockIdx.y the
// slice, and the slices are as many as it takes to give the card's SMs a
// block each (or as many as there are quad batches of one warp). After the
// first block of a group, its staging reads are L2 hits. Each output sums
// `reps` entries of its table, entry (index + k) mod len for k < reps, in
// the probe's order (acc = 0 + a_0 + a_1 ...; the TPU probe wraps once,
// the same where len >= reps). Bound: bytes, x, idx and out each moved
// once.
//
// Built with -fmad=false (trace/cuda_lib.py): the sums equal the plain torch
// versions' (probes/gather.py) bit for bit.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int ROW_W = 128;    // floats per row: one float4 per lane
constexpr int ROW_U = 4;      // rows in flight per warp (a unit)
constexpr int ROW_WARPS = 4;  // warps per block
constexpr int TILE_THREADS = 128;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float4 load_nc(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(ROW_WARPS * 32)
row_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx, int n,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int units = (n + ROW_U - 1) / ROW_U;
  const int stride = gridDim.x * ROW_WARPS;
  int u = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  // lane j < ROW_U holds the index of row j of the warp's unit
  auto index_of = [&](int unit) {
    const int r = unit * ROW_U + lane;
    return unit < units && lane < ROW_U && r < n ? __ldg(idx + r) : 0;
  };
  int mine = index_of(u);
  for (; u < units; u += stride) {
    const int next = index_of(u + stride);
    const int base = u * ROW_U, count = min(ROW_U, n - base);
    float4 v[ROW_U];
#pragma unroll
    for (int j = 0; j < ROW_U; ++j) {
      const int row = __shfl_sync(0xffffffffu, mine, j);
      if (j < count) v[j] = load_nc(table + (size_t)row * ROW_W + lane * 4);
    }
#pragma unroll
    for (int j = 0; j < ROW_U; ++j)
      if (j < count)
        __stcs(reinterpret_cast<float4*>(out + (size_t)(base + j) * ROW_W) + lane, v[j]);
    mine = next;
  }
}

// AXIS 0: tables are the 4 columns 4 * blockIdx.x.. of x [len, cols], a
// quad is one row of them; AXIS 1: the table is row blockIdx.x of
// x [rows, len], a quad is 4 of its entries. Each block does quads
// [blockIdx.y * per_block, ...) of its group.
template <int AXIS>
__global__ void __launch_bounds__(TILE_THREADS)
tile_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx, int rows, int cols,
                   int reps, int per_block, float* __restrict__ out) {
  extern __shared__ float4 tab4[];
  float* tab = reinterpret_cast<float*>(tab4);  // AXIS 0: 4 tables of len; AXIS 1: one
  const int len = AXIS == 0 ? rows : cols;
  const int g = blockIdx.x;
  if (AXIS == 0) {
    const float* src = x + g * 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < len; e += TILE_THREADS) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + (size_t)e * cols));
      tab[e] = v.x;
      tab[len + e] = v.y;
      tab[2 * len + e] = v.z;
      tab[3 * len + e] = v.w;
    }
  } else {
    const float4* src = reinterpret_cast<const float4*>(x + (size_t)g * cols);
#pragma unroll 4
    for (int e = threadIdx.x; e < len / 4; e += TILE_THREADS) tab4[e] = __ldg(src + e);
  }
  __syncthreads();
  const int quads = AXIS == 0 ? rows : cols / 4;
  const int q_begin = (int)blockIdx.y * per_block, q_end = min(quads, q_begin + per_block);
  for (int q = q_begin + (int)threadIdx.x; q < q_end; q += TILE_THREADS) {
    const size_t a = AXIS == 0 ? (size_t)q * cols + g * 4 : (size_t)g * cols + q * 4;
    const int4 i4 = __ldg(reinterpret_cast<const int4*>(idx + a));
    int ik[4] = {i4.x, i4.y, i4.z, i4.w};
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < reps; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[c] = acc[c] + tab[(AXIS == 0 ? c * len : 0) + ik[c]];
        ik[c] = ik[c] + 1 == len ? 0 : ik[c] + 1;  // (index + k) mod len
      }
    }
    reinterpret_cast<float4*>(out + a)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// The launch floor: one block that does nothing, launched and timed as the
// probes are.
__global__ void empty_kernel() {}

// The SM count of `device`, and the row kernel's resident blocks per SM
// (asked once per device).
int sm_count[MAX_DEVICES], row_blocks_per_sm[MAX_DEVICES];

cudaError_t card_shape(int device) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sm_count[device] > 0) return cudaSuccess;
  cudaError_t err =
      cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&row_blocks_per_sm[device],
                                                        row_gather_kernel, ROW_WARPS * 32, 0);
  if (err != cudaSuccess) sm_count[device] = 0;
  return err;
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers (16-byte
// aligned); the stream is the caller's cudaStream_t. Each returns the
// launch's cudaGetLastError() (0 = success); nothing synchronises. Indices
// must lie in range.
extern "C" int row_gather(int device, const float* table, const int* idx, int n, float* out,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = card_shape(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int units = (n + ROW_U - 1) / ROW_U;
    const int blocks = std::min((units + ROW_WARPS - 1) / ROW_WARPS,
                                sm_count[device] * row_blocks_per_sm[device]);
    row_gather_kernel<<<blocks, ROW_WARPS * 32, 0, (cudaStream_t)stream>>>(table, idx, n, out);
  }
  return (int)cudaGetLastError();
}

// x, idx, out [rows, cols], cols a multiple of 4; axis 0 or 1; the table
// length (rows for axis 0, cols for axis 1) at most 8,192.
extern "C" int tile_gather(int device, const float* x, const int* idx, int rows, int cols,
                           int axis, int reps, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = card_shape(device);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0 && cols > 0) {
    const int groups = axis == 0 ? cols / 4 : rows;
    const int quads = axis == 0 ? rows : cols / 4;
    // slices of a group: enough blocks for every SM, none with less than
    // a warp's quads
    const int slices =
        std::max(1, std::min((sm_count[device] + groups - 1) / groups, (quads + 31) / 32));
    const int per_block = (quads + slices - 1) / slices;
    const size_t shmem = (size_t)(axis == 0 ? 4 * rows : cols) * sizeof(float);
    const dim3 grid(groups, slices);
    if (axis == 0) {
      if (shmem > 48 * 1024)
        err = cudaFuncSetAttribute(tile_gather_kernel<0>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
      if (err == cudaSuccess)
        tile_gather_kernel<0><<<grid, TILE_THREADS, shmem, (cudaStream_t)stream>>>(
            x, idx, rows, cols, reps, per_block, out);
    } else {
      tile_gather_kernel<1><<<grid, TILE_THREADS, shmem, (cudaStream_t)stream>>>(
          x, idx, rows, cols, reps, per_block, out);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int empty_launch(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
