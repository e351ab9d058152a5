// Walk closest-hit and any-hit over spatial chunks of <=128 triangles, for
// Hopper: the world queries of every scene above 16,384 triangles.
//
// Replaces path_tracer_tpu/trace/walk.py::_walk_closest_kernel and
// ::_walk_any_kernel (contract: walk_closest_hit_shade / walk_any_hit
// there). The TPU kernels stream an XLA-built two-level bitmask of gated
// chunks through the scalar core, because that core cannot gate chunks
// cheaply; here the block gates the chunk boxes itself.
//
// Tables (trace/walk.py pack_walk):
//   aux    [k*128, 24] f32, one row per padded slot, chunk c at rows
//          c*128 .. c*128+127: cols 0-3 n0.xyz d0 | 4-7 n1.xyz d1 |
//          8-11 n2.xyz d2 | ... (pad rows are zero and never hit)
//   cb_oct [8, 6, kq] f32, chunk boxes (lo xyz | hi xyz) in each octant's
//          front-to-back order
//   ord_oct [8, kq] i32, that order as layout chunk ids
// Rays arrive t_limit-clamped to the scene box's exit, sorted by the
// coherence key for the closest hit and in the caller's order for the any
// hit; the wrapper checks shapes and types.
//
// Design (walk_common.cuh lane_walk, one walk for both queries). One block
// of 128 threads per block of 128 rays, one ray per thread. The block
// reduces its conservative ray bounds over its valid lanes (walk.py
// _block_bounds: one NaN lane must not cull a live block), then walks the
// positions of the octant order of its first ray, 128 at a time: each
// thread gates one chunk box with the _slab_lo_hi arithmetic, and a
// __ballot_sync per warp gives the survivors in order. The survivors whose
// conservative entry t passes the block window (te <= win*1.00002 + 1e-5,
// walk.py _win_admits) are taken a warp word (up to 32 boxes) at a time:
// * Segment cull. Every live lane (any hit: not yet occluded) runs its own
//   slab test of each box within its window (segment.cuh enters, the
//   stream's arithmetic): closest min(best, t_limit), any t_limit. The
//   lanes' 32-bit masks are ORed, and the block window reduced to the max
//   of the live lanes' windows, block-wide behind one barrier (shared
//   atomics into three rotating slots, so that no slot is cleared while
//   read). A box no lane entered is not staged. On bounce rays, whose
//   directions cross 0 on every axis, the block gate admits nearly every
//   chunk; the lanes' own tests cut that to the chunks some lane's segment
//   enters.
// * Lane-compacted pair tests. For each entered box, in visit order, the
//   entering lanes list their rays in shared memory, per warp by ballot and
//   popcount (a closest-hit lane first repeats its slab test with its
//   current window, which may have fallen since the mask), while the block
//   stages the chunk's plane rows into one of two buffers; one barrier
//   later thread j tests triangle j against every listed ray, so the L x
//   128 pair tests of L entering lanes spread over all 128 threads. Any
//   hit: a hit sets the ray's occluded flag in shared memory, and an
//   occluded listed ray is skipped. Closest: each listed ray has a 64-bit
//   key in shared memory; a hit at EPS < t < the listed limit does
//   atomicMin(key, float_as_uint(t) << 32 | j). t > 0, so the bits order as
//   the floats: the key ends at the chunk's least t, then lowest lane,
//   exactly the winner of a loop over its 128 rows with strict <. Two
//   buffers (rows, lists, keys) let the next chunk's staging start without
//   a second barrier; after the next barrier the owner lane merges its key
//   with strict < (t < best: best = t, slot = c*128 + j), chunk by chunk in
//   visit order, so of two chunks at one t the first visited wins.
// The cull is exact: the chunk boxes hold their triangles (pack_walk pads
// them by 1e-4 of the largest coordinate), enters is monotone in the
// window, and a lane's window never falls below its final best t; so the
// chunk of the winner, or of a tie with it, is always entered and tested,
// and winner and t equal the ungated plain version's (walk.py
// _closest_columns: minimum t, then first in visit order, then lane).
// Dead lanes (t_limit <= 0 or a non-finite origin/direction) are zeroed
// with t_limit 0: they never hit and never hold the window open; a block
// of only dead lanes returns at once, and the any-hit block stops once
// every live lane is occluded. These pieces, shared with iwalk_hit.cu,
// live in walk_common.cuh.
//
// What bounds it: FP32 ALU. Per tested ray x triangle pair, closest 42
// floating-point ops (det 5, td 6, the p-form point 9, ud and vd 7 each,
// the sign-test differences 3, the reciprocal, one Newton step 3 and t 1)
// plus 4 compares, any 41; per (live lane, admitted box) ~20 ops of
// segment test (closest: again for each entered box before listing); ~40
// ops per chunk box per block for the gate; one barrier per warp word of
// admitted boxes and one per staged chunk.
//
// Counters. With a non-null ``stats`` ([6 + k] u64, zeroed by the caller)
// each block with a live lane adds 1 to stats[0], the gate survivors its
// window admitted to stats[1], those it skipped to stats[2], for each
// staged chunk the lanes that listed their rays (entered it; any hit: and
// were not occluded) to stats[3], its staged chunks to stats[4] and its
// (lane, real triangle) pair tests to stats[5], and sets stats[6 + c] for
// every chunk c it stages (walk.py walk_stats). Off (null) on the main
// path.
//
// Floating point. Built with -fmad=false (trace/cuda_lib.py): the candidate
// t is computed exactly as the plain torch version in trace/walk.py does,
// in the JAX _chunk_terms order, with an exact reciprocal plus one Newton
// step, so the winner and t equal the plain version's bit for bit.

#include "walk_common.cuh"

namespace {

// Closest hit (walk.py _walk_closest_kernel): walk_common.cuh lane_walk
// over the baked chunks.
__global__ void __launch_bounds__(SBLK)
walk_closest_kernel(const float* __restrict__ aux, const float* __restrict__ cb_oct,
                    const int* __restrict__ ord_oct, int k, int kq,
                    const float* __restrict__ orig, const float* __restrict__ dir,
                    const float* __restrict__ tlim, int n, float* __restrict__ out_t,
                    int* __restrict__ out_slot, unsigned long long* __restrict__ stats) {
  lane_walk<false, true>(aux, cb_oct, ord_oct, nullptr, nullptr, nullptr, k, kq, 0.0f, orig, dir,
                         tlim, n, out_t, out_slot, nullptr, nullptr, stats);
}

// Shadow test (walk.py _walk_any_kernel): walk_common.cuh lane_walk over
// the baked chunks.
__global__ void __launch_bounds__(SBLK)
walk_any_kernel(const float* __restrict__ aux, const float* __restrict__ cb_oct,
                const int* __restrict__ ord_oct, int k, int kq,
                const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ tlim, int n, uint8_t* __restrict__ out,
                unsigned long long* __restrict__ stats) {
  lane_walk<false, false>(aux, cb_oct, ord_oct, nullptr, nullptr, nullptr, k, kq, 0.0f, orig,
                          dir, tlim, n, nullptr, nullptr, nullptr, out, stats);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; the stream
// is the caller's cudaStream_t. Each returns cudaGetLastError() after the
// launch (0 = success); nothing synchronises. ``stats`` may be null.
extern "C" int walk_closest(int device, const float* aux, const float* cb_oct,
                            const int* ord_oct, int k, int kq, const float* orig,
                            const float* dir, const float* tlim, int n, float* out_t,
                            int* out_slot, unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    walk_closest_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(
        aux, cb_oct, ord_oct, k, kq, orig, dir, tlim, n, out_t, out_slot, stats);
  }
  return (int)cudaGetLastError();
}

extern "C" int walk_any(int device, const float* aux, const float* cb_oct,
                        const int* ord_oct, int k, int kq, const float* orig,
                        const float* dir, const float* tlim, int n, uint8_t* out,
                        unsigned long long* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = (n + SBLK - 1) / SBLK;
    walk_any_kernel<<<blocks, SBLK, 0, (cudaStream_t)stream>>>(
        aux, cb_oct, ord_oct, k, kq, orig, dir, tlim, n, out, stats);
  }
  return (int)cudaGetLastError();
}
