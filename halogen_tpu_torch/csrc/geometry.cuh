// Ray-primitive tests and the float helpers they use, shared by the
// megakernel's bounce body (path_common.cuh), its adjoint and the BVH
// traversal (bvh_traverse.cuh), so that every route tests a sphere and a
// triangle with the same float ops in the same order.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace halogen {

// v0, e1, e2, then 3 floats: on the brute tier the geometric normal
// cross(e1, e2) (its light shadow test's plane), on the BVH tier zeros;
// three 16-byte loads
constexpr int kTriStride = 12;
constexpr int kTriRow4 = 3;      // a row in float4s
constexpr int kTrinStride = 10;  // n0, n1 - n0, n2 - n0, material
constexpr float kHitEps = 1e-4f;
constexpr float kDetEps = 1e-8f;

// ---------------------------------------------------------------------
// float helpers (megakernel.py:188-211)
// ---------------------------------------------------------------------

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 mul3(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}

// v / max(|v|, eps), divided as core/math.py normalize and the JAX package
// divide: a multiply by the reciprocal rounds an ulp apart, which a
// near-mirror lobe's pdf at its rim turns into a sky weight of 1 or 0
__device__ __forceinline__ V3 normalize3(V3 v, float eps) {
  const float n = fmaxf(sqrtf(dot3(v, v)), eps);
  return {v.x / n, v.y / n, v.z / n};
}

__device__ __forceinline__ V3 sel3(bool c, V3 a, V3 b) { return c ? a : b; }

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float safe_inv(float c) {
  const float tiny = 1e-30f;
  return 1.0f / (fabsf(c) < tiny ? tiny : c);
}

// Distance along the ray to sphere `sp` (center, radius), or INFINITY:
// the AABB pre-test against `far`, then the nearer root past HIT_EPS, or
// the farther one when the ray starts inside (`inside`).
__device__ __forceinline__ float sphere_t(const float* sp, V3 o, V3 d,
                                          V3 inv_d, float far,
                                          bool& inside) {
  const float cx = sp[0], cy = sp[1], cz = sp[2], r = sp[3];
  const float t1x = (cx - r - o.x) * inv_d.x;
  const float t2x = (cx + r - o.x) * inv_d.x;
  const float t1y = (cy - r - o.y) * inv_d.y;
  const float t2y = (cy + r - o.y) * inv_d.y;
  const float t1z = (cz - r - o.z) * inv_d.z;
  const float t2z = (cz + r - o.z) * inv_d.z;
  const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                           fminf(t1z, t2z));
  const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                           fmaxf(t1z, t2z));
  const float aabb_t = tmax > fmaxf(0.0f, tmin) ? tmin : INFINITY;
  const float ocx = o.x - cx, ocy = o.y - cy, ocz = o.z - cz;
  const float b = 2.0f * (ocx * d.x + ocy * d.y + ocz * d.z);
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
  const float disc = b * b - 4.0f * cq;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t_near = (-b - sq) * 0.5f;
  const float t_far = (-b + sq) * 0.5f;
  inside = t_near < 0.0f;
  float t = inside ? t_far : t_near;
  t = disc >= 0.0f ? t : INFINITY;
  return (aabb_t < far && t > kHitEps) ? t : INFINITY;
}

// Möller-Trumbore against the triangle (v0, e1, e2): whether the ray hits
// it past HIT_EPS, with the distance, barycentrics and determinant.
__device__ __forceinline__ bool triangle_hit(V3 v0, V3 e1, V3 e2, V3 o, V3 d,
                                             float& t, float& u, float& v,
                                             float& det) {
  const V3 pvec = cross3(d, e2);
  det = dot3(pvec, e1);
  const bool parallel = fabsf(det) < kDetEps;
  const float inv_det = 1.0f / (parallel ? 1.0f : det);
  const V3 tvec = {o.x - v0.x, o.y - v0.y, o.z - v0.z};
  u = dot3(tvec, pvec) * inv_det;
  const V3 qvec = cross3(tvec, e1);
  v = dot3(d, qvec) * inv_det;
  t = dot3(e2, qvec) * inv_det;
  return !parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t > 0.0f && t > kHitEps;
}

// The same test on a brute-tier row `tv` in shared memory: 12 floats (v0,
// e1, e2, the normal), 16-byte aligned, read as three 16-byte loads.
__device__ __forceinline__ bool triangle_hit(const float* tv, V3 o, V3 d,
                                             float& t, float& u, float& v,
                                             float& det) {
  const float4* row = reinterpret_cast<const float4*>(tv);
  const float4 a = row[0], b = row[1], c = row[2];
  return triangle_hit(V3{a.x, a.y, a.z}, V3{a.w, b.x, b.y},
                      V3{b.z, b.w, c.x}, o, d, t, u, v, det);
}

// The same test on a BVH-tier row in global memory (the same layout), read
// through the read-only path.
__device__ __forceinline__ bool triangle_hit(const float4* row, V3 o, V3 d,
                                             float& t, float& u, float& v,
                                             float& det) {
  const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
  return triangle_hit(V3{a.x, a.y, a.z}, V3{a.w, b.x, b.y},
                      V3{b.z, b.w, c.x}, o, d, t, u, v, det);
}

}  // namespace halogen
