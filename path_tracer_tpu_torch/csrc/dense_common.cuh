// The pieces the dense kernels share (dense_hit.cu: one <=16K-triangle
// table; dense_stream.cu: the streamed engine up to 2M triangles): the
// constants and the ray x triangle pair tests of
// dense_pallas._chunk_terms_vpu. See
// the note at the top of dense_hit.cu for the floating-point rules
// (-fmad=false; the plain torch versions in trace/dense_cuda.py repeat these
// expressions in this order).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int AUX_COLS = 24;
constexpr float EPS = 5e-4f;  // core/constants.py EPSILON
constexpr float BIG = 1e30f;  // "no winner" sentinel (dense_pallas._BIG)

__device__ __forceinline__ bool same_sign(float a, float b) {
  return (a >= 0.0f) == (b >= 0.0f);
}

// The four search terms of dense_pallas._chunk_terms_vpu.
struct Terms {
  float det, td, ud, vd;
};

__device__ __forceinline__ Terms terms(float ox, float oy, float oz, float dx,
                                       float dy, float dz, float4 a, float4 b,
                                       float4 c) {
  Terms r;
  r.det = dx * a.x + dy * a.y + dz * a.z;
  r.td = a.w - (ox * a.x + oy * a.y + oz * a.z);
  r.ud = r.det * ((ox * b.x + oy * b.y + oz * b.z) + b.w) +
         r.td * (dx * b.x + dy * b.y + dz * b.z);
  r.vd = r.det * ((ox * c.x + oy * c.y + oz * c.z) + c.w) +
         r.td * (dx * c.x + dy * c.y + dz * c.z);
  return r;
}

// Closest-hit search test: the candidate t (1/det plus one Newton step, as
// on the TPU) and whether the pair hits with EPS < t < tl.
__device__ __forceinline__ bool closest_pair(const Terms& q, float tl, float& t) {
  const bool c2 = same_sign(q.ud, q.det - q.ud);
  const bool c3 = same_sign(q.vd, q.det - q.ud - q.vd);
  const float safe = q.det == 0.0f ? 1.0f : q.det;
  float r = 1.0f / safe;
  r = r * (2.0f - safe * r);  // one Newton step, as on the TPU
  t = q.td * r;
  return c2 && c3 && q.det != 0.0f && t > EPS && t < tl;
}

// Shadow test, division-free: a hit iff sign(td - det*eps) ==
// sign(det*tlim - td) plus the two barycentric sign tests.
__device__ __forceinline__ bool shadow_pair(const Terms& q, float tl) {
  const bool c1 = same_sign(q.td - q.det * EPS, q.det * tl - q.td);
  const bool c2 = same_sign(q.ud, q.det - q.ud);
  const bool c3 = same_sign(q.vd, q.det - q.ud - q.vd);
  return c1 && c2 && c3 && q.det != 0.0f;
}

}  // namespace
