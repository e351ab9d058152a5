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
// Tables (trace/iwalk.py pack_vwalk / pack_iwalk, and upload):
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
// iwalk: a gate entry is an instance (the world box of its model's object
//   box); under it the port's object tables (trace/iwalk.py
//   pack_object_boxes): ocb [K, 6] f32 the object chunk boxes, padded;
//   opb [P, 6] f32 the boxes of the parts, runs of at most 32 chunks of one
//   model; part_c [P, 2] i32 each part's chunk range; inst_p [I, 2] i32
//   each instance's part range.
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
// iwalk: walk_common.cuh inst_walk, a per-lane cull in three levels, each
// lane's own slab test (segment.cuh enters) within its own window (closest:
// min(best, t_limit); any hit: t_limit while unoccluded):
//   1. instances: the block gates 128 instance world boxes at a time in the
//      octant order of its first ray (a warp ballot, the block window), and
//      each live lane tests the admitted boxes of a warp word, widened by
//      ``slack`` as vwalk's; the masks are ORed block-wide behind one
//      barrier;
//   2. for each instance some lane entered, in visit order, each entering
//      lane computes its object-space ray once (obj_ray) and tests the
//      instance's part boxes, 32 at a time, ORed block-wide (no barrier for
//      a model of one part);
//   3. for each part some lane entered, in ascending order, its lanes test
//      its chunk boxes (at most 32), ORed block-wide; each chunk some lane
//      entered is staged in ascending order (walk_common.cuh stage_chunk),
//      the lanes that (closest: still) enter it list their object-space
//      rays, and thread j tests triangle j against every listed ray.
// The instances come in the contract's visit order and the chunks of an
// instance in ascending order, so the closest hit's (t, triangle) key,
// merged with strict < after the next barrier, keeps the contract's tie
// order: minimum t, then the first instance in the block's octant order,
// then the lowest chunk, then the lowest lane. The any hit flags an
// occluded lane; the lane stops listing, and the block leaves at the next
// barrier (a staging or a block OR) once no valid lane is open.
// The cull is exact: the object chunk boxes hold the triangles the pair
// test sees (their vertices solved from the plane rows, padded by 1e-4 of
// the model's largest coordinate, as the walk pads its chunk boxes), a
// part's box holds its chunks', the instance box with ``slack`` holds the
// world segment of every object hit (lane_slack), and enters is monotone
// in the box and the window: winner, instance and t equal the ungated
// plain version's on every ray, ties included.
//
// What bounds it: FP32 ALU per tested ray x triangle pair (closest 42 ops,
// any 41, as in walk_hit.cu), plus the transform (30 ops per ray per
// listing for vwalk, per entered instance for iwalk) and the lanes'
// segment tests (~20 ops per live lane and tested box: vwalk's admitted
// virtual chunks; iwalk's admitted instances, the part boxes of each
// entered instance and the chunk boxes of each entered part). On the card
// both walks run far above that bound, for the barriers: one per warp
// word of admitted boxes, one per staged chunk, and for iwalk one per part
// word of a many-part model and per entered part.
//
// Outputs. Closest: best t, the object-global slot (chunk*128 + lane) and
// the instance, or (1e30, -1, -1) on a miss. Any: one flag per ray.
//
// Counters. With a non-null ``stats`` (zeroed by the caller) each block
// with a live lane adds stats[0..5] as in walk_hit.cu (blocks with a live
// lane, gate entries admitted, survivors the window skipped, lanes listed
// on a staged chunk summed over stagings, staged chunks, (lane, real
// triangle) pairs); vwalk ([6 + entries] u64) sets stats[6 + e] for every
// virtual chunk e it stages; iwalk ([9 + I] u64) adds the (lane, instance),
// (lane, part) and (lane, chunk) box tests that entered to stats[6..8] and
// sets stats[9 + i] for every instance i some lane entered. Off on the
// main path.
//
// Floating point: -fmad=false; the transform and the pair test repeat the
// plain torch versions' (trace/iwalk.py) expressions in their order, so
// winner and t equal the plain version's bit for bit.

#include "walk_common.cuh"

namespace {

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

// Closest hit (iwalk.py _iwalk_closest_kernel): walk_common.cuh inst_walk.
__global__ void __launch_bounds__(SBLK)
iwalk_closest_kernel(const float* __restrict__ aux, const float* __restrict__ cb_oct,
                     const int* __restrict__ ord_oct, const int* __restrict__ inst_p,
                     const int* __restrict__ part_c, const float* __restrict__ ocb,
                     const float* __restrict__ opb, const float* __restrict__ inst_f, int k,
                     int kq, float slack, const float* __restrict__ orig,
                     const float* __restrict__ dir, const float* __restrict__ tlim, int n,
                     float* __restrict__ out_t, int* __restrict__ out_slot,
                     int* __restrict__ out_inst, unsigned long long* __restrict__ stats) {
  inst_walk<true>(aux, cb_oct, ord_oct, inst_p, part_c, ocb, opb, inst_f, k, kq, slack, orig, dir,
                  tlim, n, out_t, out_slot, out_inst, nullptr, stats);
}

// Shadow test (iwalk.py _iwalk_any_kernel): walk_common.cuh inst_walk.
// Eight blocks per SM (64 registers, a few spilled) rather than the five
// that 92 registers allow: its launches wait on per-block barrier chains,
// and more resident blocks hide them (PERF.md section 5, the lb8 design step).
__global__ void __launch_bounds__(SBLK, 8)
iwalk_any_kernel(const float* __restrict__ aux, const float* __restrict__ cb_oct,
                 const int* __restrict__ ord_oct, const int* __restrict__ inst_p,
                 const int* __restrict__ part_c, const float* __restrict__ ocb,
                 const float* __restrict__ opb, const float* __restrict__ inst_f, int k, int kq,
                 float slack, const float* __restrict__ orig, const float* __restrict__ dir,
                 const float* __restrict__ tlim, int n, uint8_t* __restrict__ out,
                 unsigned long long* __restrict__ stats) {
  inst_walk<false>(aux, cb_oct, ord_oct, inst_p, part_c, ocb, opb, inst_f, k, kq, slack, orig,
                   dir, tlim, n, nullptr, nullptr, nullptr, out, stats);
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
                             const int* ord_oct, const int* inst_p, const int* part_c,
                             const float* ocb, const float* opb, const float* inst_f, int k,
                             int kq, float slack, const float* orig, const float* dir,
                             const float* tlim, int n, float* out_t, int* out_slot,
                             int* out_inst, unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    iwalk_closest_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(
        aux, cb_oct, ord_oct, inst_p, part_c, ocb, opb, inst_f, k, kq, slack, orig, dir, tlim, n,
        out_t, out_slot, out_inst, stats);
  }
  return (int)cudaGetLastError();
}

extern "C" int iwalk_any(int device, const float* aux, const float* cb_oct,
                         const int* ord_oct, const int* inst_p, const int* part_c,
                         const float* ocb, const float* opb, const float* inst_f, int k, int kq,
                         float slack, const float* orig, const float* dir, const float* tlim,
                         int n, uint8_t* out, unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    iwalk_any_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(
        aux, cb_oct, ord_oct, inst_p, part_c, ocb, opb, inst_f, k, kq, slack, orig, dir, tlim, n,
        out, stats);
  }
  return (int)cudaGetLastError();
}
