// Two-level closest-hit and any-hit for Hopper: shared object-space chunk
// tables walked through per-instance rigid transforms (scenes built with
// two_level=True).
//
// Replaces, in path_tracer_tpu/trace/iwalk.py (contract:
// iwalk_closest_hit_shade / iwalk_any_hit there):
//   vwalk_closest_kernel  <- _vwalk_closest_kernel
//   vwalk_any_kernel      <- _vwalk_any_kernel
//   iwalk_closest_kernel  <- _iwalk_closest_kernel
//   iwalk_any_kernel      <- _iwalk_any_kernel
//
// Tables (trace/iwalk.py pack_vwalk / pack_iwalk):
//   aux     [K*128, 24] f32, the OBJECT-space plane rows of every model's
//           chunks (chunk c at rows c*128 .. c*128+127), shared by all the
//           instances of a model
//   inst_f  [I, 12] f32, each instance's inverse rigid transform: rotation
//           rows r0..r8, translation r9..r11
//   cb_oct  [8, 6, kq] f32, gate boxes in each octant's front-to-back order
//   ord_oct [8, kq] i32, that order
// vwalk: a gate entry is a virtual chunk, one (instance, object chunk)
//   pair, with the world box of the object chunk's 8 transformed corners;
//   vinst/vglob [kq] i32 give the instance and the object chunk of each
//   layout slot.
// iwalk: a gate entry is an instance (its world box); inst_c [I, 2] i32 is
//   the object chunk range [c0, c1) that an admitted instance brute-walks.
//
// vwalk: walk_hit.cu's lane walk (walk_common.cuh lane_walk), for the
// closest hit and the any hit: the block gates 128 virtual chunk world
// boxes at a time in the octant order of its first ray; each live lane
// runs its own segment test of every admitted box within its window
// (closest: min(best, t_limit)); an entered box's object chunk is staged
// once, and each entering lane lists its object-space ray (obj_ray, once
// per staged chunk, the 12 inst_f floats in _obj_rays' order; rigid, so t
// needs no rescale and the window and the winner merge stay in world t)
// for the lane-compacted pair tests; the closest hit merges each chunk's
// 64-bit (t, triangle) key with strict <, slot = object chunk * 128 +
// triangle and the instance of the virtual chunk. The world box holds the
// 8 float32-transformed corners of an unpadded object box, and the pair
// test runs in object space, so the lanes test the box widened by
// ``slack`` on every side, which bounds the rounding of both frames
// (trace/iwalk.py lane_slack): the cull stays exact, and winner, instance
// and t equal the ungated plain version's.
//
// iwalk: walk_common.cuh's block walk. The block reduces its world-space
// ray bounds, gates 128 instance boxes at a time with a warp ballot and
// visits the survivors in the octant order of its first ray, skipping an
// entry whose entry t fails the live window. On a visit every thread
// transforms its own ray into the instance's object space (a broadcast
// load: every lane reads the same address); the block stages every chunk
// of the instance's range (128 plane rows, three float4 each) and every
// thread tests them, reducing the window after each chunk, and the any-hit
// leaves the range once every live lane is occluded. Dead lanes and blocks
// behave as in walk_hit.cu.
//
// What bounds it: FP32 ALU per tested ray x triangle pair (closest 42 ops,
// any 41, as in walk_hit.cu), plus the transform (30 ops per ray per
// listing for vwalk, per visit for iwalk), vwalk's segment tests (~20 ops
// per live lane and admitted box) and the gate scan (~40 ops per box per
// block). iwalk tests every chunk of an admitted instance: on a
// 442,368-triangle knot (5,033 chunks) one admitted instance costs a block
// 5,033 stagings, so iwalk is far slower than vwalk there and is the engine
// only above vwalk's virtual-chunk cap (or on request).
//
// Outputs. Closest: best t, the object-global slot (chunk*128 + lane) and
// the instance, or (1e30, -1, -1) on a miss. Any: one flag per ray.
//
// Counters. With a non-null ``stats`` ([6 + entries] u64, zeroed by the
// caller) each block adds stats[0..5] as in walk_hit.cu (blocks with a live
// lane, gate entries visited, survivors the window skipped, lanes testing
// a staged chunk (vwalk: those that listed their rays), summed over
// stagings, staged chunks, and for vwalk the (lane, real triangle) pairs),
// and sets stats[6 + e] for every gate entry e it visits (vwalk: stages).
// Off on the main path.
//
// Floating point: -fmad=false; the transform and the pair test repeat the
// plain torch versions' (trace/iwalk.py) expressions in their order, so
// winner and t equal the plain version's bit for bit.

#include "walk_common.cuh"

namespace {

__device__ __forceinline__ void write_closest(int n, float best, int slot, int inst,
                                              float* __restrict__ out_t,
                                              int* __restrict__ out_slot,
                                              int* __restrict__ out_inst) {
  const int ray = blockIdx.x * SBLK + threadIdx.x;
  if (ray < n) {
    out_t[ray] = best;
    out_slot[ray] = slot;
    out_inst[ray] = slot >= 0 ? inst : -1;
  }
}

// Closest hit (iwalk.py _vwalk_closest_kernel): walk_common.cuh lane_walk
// over the virtual chunks, the lanes' segment tests against the world
// boxes widened by ``slack`` (trace/iwalk.py lane_slack).
__global__ void __launch_bounds__(SBLK)
vwalk_closest_kernel(const float* __restrict__ aux, const float* __restrict__ cb_oct,
                     const int* __restrict__ ord_oct, const int* __restrict__ vinst,
                     const int* __restrict__ vglob, const float* __restrict__ inst_f, int k,
                     int kq, float slack, const float* __restrict__ orig,
                     const float* __restrict__ dir, const float* __restrict__ tlim, int n,
                     float* __restrict__ out_t, int* __restrict__ out_slot,
                     int* __restrict__ out_inst, unsigned long long* __restrict__ stats) {
  lane_walk<true, true>(aux, cb_oct, ord_oct, vinst, vglob, inst_f, k, kq, slack, orig, dir, tlim,
                        n, out_t, out_slot, out_inst, nullptr, stats);
}

// Shadow test (iwalk.py _vwalk_any_kernel): walk_common.cuh lane_walk over
// the virtual chunks, as vwalk_closest_kernel.
__global__ void __launch_bounds__(SBLK)
vwalk_any_kernel(const float* __restrict__ aux, const float* __restrict__ cb_oct,
                 const int* __restrict__ ord_oct, const int* __restrict__ vinst,
                 const int* __restrict__ vglob, const float* __restrict__ inst_f, int k, int kq,
                 float slack, const float* __restrict__ orig, const float* __restrict__ dir,
                 const float* __restrict__ tlim, int n, uint8_t* __restrict__ out,
                 unsigned long long* __restrict__ stats) {
  lane_walk<true, false>(aux, cb_oct, ord_oct, vinst, vglob, inst_f, k, kq, slack, orig, dir,
                         tlim, n, nullptr, nullptr, nullptr, out, stats);
}

__global__ void __launch_bounds__(SBLK)
iwalk_closest_kernel(const float* __restrict__ aux, const float* __restrict__ cb_oct,
                     const int* __restrict__ ord_oct, const int* __restrict__ inst_c,
                     const float* __restrict__ inst_f, int k, int kq,
                     const float* __restrict__ orig, const float* __restrict__ dir,
                     const float* __restrict__ tlim, int n, float* __restrict__ out_t,
                     int* __restrict__ out_slot, int* __restrict__ out_inst,
                     unsigned long long* __restrict__ stats) {
  __shared__ Shared sh;
  const Ray r = load_ray(orig, dir, tlim, n, sh);
  block_bounds(r, sh);

  float best = BIG;
  int slot = -1, inst = -1;
  unsigned long long visits = 0, skips = 0, lanes = 0, stagings = 0;
  if (sh.bb.anyv) {
    const int* ord = ord_oct + (size_t)sh.bb.oct * kq;
    float win = sh.bb.tmax;  // uniform across the block
    for (int base = 0; base < k; base += SBLK) {
      gate_batch(cb_oct, k, kq, base, sh);
      for (int w = 0; w < WARPS; ++w) {
        unsigned m = sh.bits[w];
        while (m) {
          const int q = w * 32 + __ffs(m) - 1;
          m &= m - 1;
          if (!admits(sh.te[q], win)) {  // once per instance, as on the TPU
            ++skips;
            continue;
          }
          ++visits;
          const int i = ord[base + q];
          const Ray o = obj_ray(r, inst_f, i);
          for (int c = inst_c[2 * i]; c < inst_c[2 * i + 1]; ++c) {
            if (stats != nullptr) lanes += mark(stats + NSTATS, i, r.valid);
            ++stagings;
            stage(aux, c, sh);
            if (r.valid && closest_chunk(o, sh, c, best, slot)) inst = i;
            win = fminf(win, block_max(fminf(best, r.tl), sh));
          }
        }
      }
    }
  }
  write_closest(n, best, slot, inst, out_t, out_slot, out_inst);
  count(stats, sh.bb.anyv, visits, skips, lanes, stagings);
}

__global__ void __launch_bounds__(SBLK)
iwalk_any_kernel(const float* __restrict__ aux, const float* __restrict__ cb_oct,
                 const int* __restrict__ ord_oct, const int* __restrict__ inst_c,
                 const float* __restrict__ inst_f, int k, int kq,
                 const float* __restrict__ orig, const float* __restrict__ dir,
                 const float* __restrict__ tlim, int n, uint8_t* __restrict__ out,
                 unsigned long long* __restrict__ stats) {
  __shared__ Shared sh;
  const Ray r = load_ray(orig, dir, tlim, n, sh);
  block_bounds(r, sh);

  bool occ = false;
  unsigned long long visits = 0, skips = 0, lanes = 0, stagings = 0;
  if (sh.bb.anyv) {
    const int* ord = ord_oct + (size_t)sh.bb.oct * kq;
    float win = sh.bb.tmax;  // uniform; <= 0 once every live lane is occluded
    for (int base = 0; base < k && win > 0.0f; base += SBLK) {
      gate_batch(cb_oct, k, kq, base, sh);
      for (int w = 0; w < WARPS && win > 0.0f; ++w) {
        unsigned m = sh.bits[w];
        while (m && win > 0.0f) {
          const int q = w * 32 + __ffs(m) - 1;
          m &= m - 1;
          if (!admits(sh.te[q], win)) {
            ++skips;
            continue;
          }
          ++visits;
          const int i = ord[base + q];
          const Ray o = obj_ray(r, inst_f, i);
          for (int c = inst_c[2 * i]; c < inst_c[2 * i + 1] && win > 0.0f; ++c) {
            if (stats != nullptr) lanes += mark(stats + NSTATS, i, r.valid && !occ);
            ++stagings;
            stage(aux, c, sh);
            if (r.valid && !occ) occ = any_chunk(o, sh);
            win = fminf(win, block_max(occ ? 0.0f : r.tl, sh));
          }
        }
      }
    }
  }
  const int ray = blockIdx.x * SBLK + threadIdx.x;
  if (ray < n) out[ray] = occ ? 1 : 0;
  count(stats, sh.bb.anyv, visits, skips, lanes, stagings);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; the stream
// is the caller's cudaStream_t. Each returns cudaGetLastError() after the
// launch (0 = success); nothing synchronises. ``stats`` may be null. ``k``
// is the number of gate entries (virtual chunks for vwalk, instances for
// iwalk), ``kq`` the columns of cb_oct / ord_oct.
extern "C" int vwalk_closest(int device, const float* aux, const float* cb_oct,
                             const int* ord_oct, const int* vinst, const int* vglob,
                             const float* inst_f, int k, int kq, float slack,
                             const float* orig, const float* dir, const float* tlim, int n,
                             float* out_t, int* out_slot, int* out_inst,
                             unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    vwalk_closest_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(
        aux, cb_oct, ord_oct, vinst, vglob, inst_f, k, kq, slack, orig, dir, tlim, n, out_t,
        out_slot, out_inst, stats);
  }
  return (int)cudaGetLastError();
}

extern "C" int vwalk_any(int device, const float* aux, const float* cb_oct,
                         const int* ord_oct, const int* vinst, const int* vglob,
                         const float* inst_f, int k, int kq, float slack, const float* orig,
                         const float* dir, const float* tlim, int n, uint8_t* out,
                         unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    vwalk_any_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(
        aux, cb_oct, ord_oct, vinst, vglob, inst_f, k, kq, slack, orig, dir, tlim, n, out, stats);
  }
  return (int)cudaGetLastError();
}

extern "C" int iwalk_closest(int device, const float* aux, const float* cb_oct,
                             const int* ord_oct, const int* inst_c, const float* inst_f,
                             int k, int kq, const float* orig, const float* dir,
                             const float* tlim, int n, float* out_t, int* out_slot,
                             int* out_inst, unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    iwalk_closest_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(
        aux, cb_oct, ord_oct, inst_c, inst_f, k, kq, orig, dir, tlim, n, out_t, out_slot,
        out_inst, stats);
  }
  return (int)cudaGetLastError();
}

extern "C" int iwalk_any(int device, const float* aux, const float* cb_oct,
                         const int* ord_oct, const int* inst_c, const float* inst_f, int k,
                         int kq, const float* orig, const float* dir, const float* tlim,
                         int n, uint8_t* out, unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    iwalk_any_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(
        aux, cb_oct, ord_oct, inst_c, inst_f, k, kq, orig, dir, tlim, n, out, stats);
  }
  return (int)cudaGetLastError();
}
