// The per-lane segment cull, shared by the streamed dense kernels
// (dense_stream.cu) and the walk and vwalk any-hit kernels
// (walk_common.cuh): one ray's own slab test of a chunk box within its
// window, and the window slack every gated kernel uses. The plain torch
// model is trace/walk.py lane_enters (same expressions, same order;
// -fmad=false).

#pragma once

namespace {

constexpr float WIN_MUL = 1.00002f;  // window slack: t <= tw*WIN_MUL + WIN_ADD
constexpr float WIN_ADD = 1e-5f;

// Whether the ray (origin o, direction d, inv[a] = 1/d[a], or 0 where d[a]
// is 0) meets the box (lo xyz | hi xyz) within [0, tw*WIN_MUL + WIN_ADD].
// An inverted box (lo > hi on an axis, or NaN) is never entered; on an axis
// where d is 0 the origin must lie within the slab.
__device__ __forceinline__ bool enters(const float (&o)[3], const float (&d)[3],
                                       const float (&inv)[3], const float* box, float tw) {
  float t_near = 0.0f, t_far = tw * WIN_MUL + WIN_ADD;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = box[a], hi = box[3 + a];
    if (!(lo <= hi)) return false;
    if (d[a] == 0.0f) {
      if (o[a] < lo || o[a] > hi) return false;
    } else {
      const float t1 = (lo - o[a]) * inv[a];
      const float t2 = (hi - o[a]) * inv[a];
      t_near = fmaxf(t_near, fminf(t1, t2));
      t_far = fminf(t_far, fmaxf(t1, t2));
    }
  }
  return t_near <= t_far;
}

}  // namespace
