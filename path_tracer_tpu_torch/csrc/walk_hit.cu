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
// Design. One block of 128 threads per block of 128 rays, one ray per
// thread. The block reduces its conservative ray bounds over its valid
// lanes (walk.py _block_bounds: one NaN lane must not cull a live block),
// then walks the positions of the octant order of its first ray, 128 at a
// time: each thread gates one chunk box with the _slab_lo_hi arithmetic,
// and a __ballot_sync per warp gives the survivors in order. For each
// survivor whose conservative entry t passes the live window
// (te <= win*1.00002 + 1e-5, walk.py _win_admits):
// * closest hit: the block stages the chunk's 128 plane rows (three float4
//   each) into shared memory, every thread tests its ray against all of
//   them, and the window shrinks to the block-wide max of min(best,
//   t_limit);
// * any hit (walk_common.cuh any_walk): the survivors are taken a warp word
//   (up to 32 boxes) at a time. Every live, unoccluded lane runs its own
//   slab test of each box within [0, t_limit] (segment.cuh enters, the
//   stream's arithmetic; exact, since pack_walk pads the chunk boxes by
//   1e-4 of the largest coordinate), giving a 32-bit mask; the masks are
//   ORed and the window (the max of the unoccluded lanes' t_limit) reduced
//   block-wide behind one barrier. A box no lane entered is not staged.
//   For each entered box, the entering lanes (those not yet occluded) list
//   their rays in shared memory, per warp by ballot and popcount, while
//   the block stages the chunk's plane rows into one of two buffers; one
//   barrier later thread j tests triangle j against every listed ray, so
//   the L x 128 pair tests of L entering lanes spread over all 128 threads
//   instead of running 128 deep on each lane, and a hit sets the ray's
//   occluded flag in shared memory (any finder will do). A listed ray found
//   occluded is skipped. With two buffers the next chunk's staging needs no
//   second barrier.
// Dead lanes (t_limit <= 0 or a non-finite origin/direction) are zeroed
// with t_limit 0: they never hit and never hold the window open; a block
// of only dead lanes returns at once, and the any-hit block stops once
// every live lane is occluded. These pieces, shared with iwalk_hit.cu,
// live in walk_common.cuh.
//
// What bounds it: FP32 ALU per tested ray x triangle pair (closest: 42
// floating-point ops — det 5, td 6, the p-form point 9, ud and vd 7 each,
// the sign-test differences 3, the reciprocal, one Newton step 3 and t 1 —
// plus 4 compares; any hit: 41), plus the gate scan (~40 ops per chunk box
// per block). Closest: every visit stages and tests 128 x 128 pairs behind
// two block barriers. Any hit: ~20 ops per (live lane, surviving box) for
// the segment tests, one barrier per batch of boxes and one per staged
// chunk, and only the entering lanes' pairs.
//
// Counters. With a non-null ``stats`` ([6 + k] u64, zeroed by the caller)
// each block with a live lane adds 1 to stats[0], the gate survivors its
// window admitted to stats[1], those it skipped to stats[2], for each
// staged chunk the lanes that test it (closest: the live ones; any hit:
// those that entered it and were not occluded) to stats[3], its staged
// chunks to stats[4] (closest: its visits) and, any hit only, its (lane,
// real triangle) pair tests to stats[5], and sets stats[6 + c] for every
// chunk c it stages (walk.py walk_stats). Off (null) on the main path.
//
// Floating point. Built with -fmad=false (trace/cuda_lib.py): the candidate
// t is computed exactly as the plain torch version in trace/walk.py does,
// in the JAX _chunk_terms order, with an exact reciprocal plus one Newton
// step, so the winner and t equal the plain version's bit for bit. Ties go
// to the first visited chunk (strict <), then the lowest lane.

#include "walk_common.cuh"

namespace {

__global__ void __launch_bounds__(SBLK)
walk_closest_kernel(const float* __restrict__ aux, const float* __restrict__ cb_oct,
                    const int* __restrict__ ord_oct, int k, int kq,
                    const float* __restrict__ orig, const float* __restrict__ dir,
                    const float* __restrict__ tlim, int n, float* __restrict__ out_t,
                    int* __restrict__ out_slot, unsigned long long* __restrict__ stats) {
  __shared__ Shared sh;
  const Ray r = load_ray(orig, dir, tlim, n, sh);
  block_bounds(r, sh);

  float best = BIG;
  int slot = -1;
  unsigned long long visits = 0, skips = 0, lanes = 0;
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
          if (!admits(sh.te[q], win)) {
            ++skips;
            continue;
          }
          ++visits;
          const int c = ord[base + q];
          if (stats != nullptr) lanes += mark(stats + NSTATS, c, r.valid);
          stage(aux, c, sh);
          if (r.valid) closest_chunk(r, sh, c, best, slot);
          win = fminf(win, block_max(fminf(best, r.tl), sh));
        }
      }
    }
  }
  const int ray = blockIdx.x * SBLK + threadIdx.x;
  if (ray < n) {
    out_t[ray] = best;
    out_slot[ray] = slot;
  }
  count(stats, sh.bb.anyv, visits, skips, lanes, visits);
}

// Shadow test (walk.py _walk_any_kernel): walk_common.cuh any_walk over
// the baked chunks.
__global__ void __launch_bounds__(SBLK)
walk_any_kernel(const float* __restrict__ aux, const float* __restrict__ cb_oct,
                const int* __restrict__ ord_oct, int k, int kq,
                const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ tlim, int n, uint8_t* __restrict__ out,
                unsigned long long* __restrict__ stats) {
  any_walk<false>(aux, cb_oct, ord_oct, nullptr, nullptr, nullptr, k, kq, 0.0f, orig, dir,
                  tlim, n, out, stats);
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
