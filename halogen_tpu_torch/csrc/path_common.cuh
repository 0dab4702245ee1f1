// The path of one ray, shared by the forward megakernel (megakernel.cu)
// and its adjoint (adjoint.cu).
//
// Both kernels trace a ray through `path_bounce`, the bounce body of the
// brute-force tier of the Pallas megakernel
// (`halogen_tpu/kernels/megakernel.py:1073-1554`): sampler draws, closest
// hit against every sphere and triangle, emission, the BRDF, per-type
// bounce limits, Russian roulette and the deferred-miss record. Three
// compile-time switches select the variant, as the Pallas kernel is
// specialized statically:
//   kTransmissive (B1b, replaces `_Stack` :225-358 and the branches at
//     :1241-1263, :1311-1365): a per-thread nested-dielectric medium
//     stack, refraction with TIR, false hits that pass through, the
//     bandaid pop and Beer-Lambert through the current medium;
//   kEnvNee (B1c, replaces :1380-1504, :1547-1553): an envmap NEE draw
//     per bounce from the alias table, a shadow ray against the scene
//     tables, the balance heuristic against the continuation pdf, and
//     the MIS state the deferred sky pass reads at the miss;
//   kBvh (B1d, replaces the raylet tier `_make_raylet_traversal` :523 and
//     its occlusion mode :749-752, :1443-1450): the closest hit walks the
//     world BVH (bvh_traverse.cuh) instead of scanning every triangle,
//     and the env-NEE shadow ray is an any-hit walk; the triangles stay
//     in global memory. Only the forward kernel has it.
// With all three off the body is B1a's, op for op. Because the code is one,
// and both files are built with the same flags (-fmad=false, no fast
// math), the adjoint's replay takes the forward kernel's path bit for
// bit; a copy that drifted by one ulp could flip a Fresnel, refraction or
// Russian-roulette decision and give the gradient of another path.
//
// Float ops follow the Pallas body op for op: the same formulas, the same
// selection order, strict `<` for first-min ties, `>` for the bounce
// limits, RR's 1/p after the kill test and the roughness accumulator's
// `.x` quirk.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "bvh_traverse.cuh"
#include "geometry.cuh"

namespace halogen {

constexpr int kThreads = 128;
constexpr int kSphStride = 5;    // center, radius, material
constexpr int kMatStride = 17;   // see megakernel.py::_scene_tables
constexpr float kOffsetEps = 1e-4f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 0.318309886183790671538f;  // float32(1 / pi)
constexpr float kInvU32 = 1.0f / 4294967296.0f;

// Sobol direction numbers of dimension 1 (dimension 0 is bit reversal).
__constant__ uint32_t kSobolDim1[32] = {
    0x80000000u, 0xC0000000u, 0xA0000000u, 0xF0000000u,
    0x88000000u, 0xCC000000u, 0xAA000000u, 0xFF000000u,
    0x80800000u, 0xC0C00000u, 0xA0A00000u, 0xF0F00000u,
    0x88880000u, 0xCCCC0000u, 0xAAAA0000u, 0xFFFF0000u,
    0x80008000u, 0xC000C000u, 0xA000A000u, 0xF000F000u,
    0x88008800u, 0xCC00CC00u, 0xAA00AA00u, 0xFF00FF00u,
    0x80808080u, 0xC0C0C0C0u, 0xA0A0A0A0u, 0xF0F0F0F0u,
    0x88888888u, 0xCCCCCCCCu, 0xAAAAAAAAu, 0xFFFFFFFFu,
};

// ---------------------------------------------------------------------
// uint32 sampler (mirrors sampler/sobol.py and megakernel.py:88-183)
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t owen_scramble(uint32_t value,
                                                  uint32_t seed) {
  uint32_t x = __brev(value);
  x ^= x * 0x3D20ADEAu;
  x += seed;
  x *= (seed >> 16) | 1u;
  x ^= x * 0x05526C56u;
  x ^= x * 0x53A22864u;
  return __brev(x);
}

__device__ __forceinline__ uint32_t u32_hash(uint32_t v) {
  uint32_t state = v * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ uint32_t hash_combine(uint32_t seed, uint32_t v) {
  return seed ^ (v + (seed << 6) + (seed >> 2));
}

__device__ __forceinline__ uint32_t sobol_dim1(uint32_t index) {
  uint32_t x = 0u;
#pragma unroll
  for (int bit = 0; bit < 32; ++bit) {
    x ^= ((index >> bit) & 1u) * kSobolDim1[bit];
  }
  return x;
}

__device__ __forceinline__ float to_unit(uint32_t u) {
  return __uint2float_rn(u) * kInvU32;
}

__device__ __forceinline__ void sample_2d(bool sobol, uint32_t index,
                                          uint32_t dim, uint32_t seed,
                                          float* a, float* b) {
  if (sobol) {  // ld_sample_2d
    uint32_t sd = seed ^ u32_hash(dim);
    uint32_t shuffled = owen_scramble(index, sd);
    *a = to_unit(owen_scramble(__brev(shuffled), hash_combine(sd, 0u)));
    *b = to_unit(owen_scramble(sobol_dim1(shuffled), hash_combine(sd, 1u)));
  } else {  // prng_sample_2d
    uint32_t h0 = hash_combine(hash_combine(seed, index), dim);
    *a = to_unit(u32_hash(h0));
    *b = to_unit(u32_hash(h0 ^ 0x9E3779B9u));
  }
}

__device__ __forceinline__ float sample_1d(bool sobol, uint32_t index,
                                           uint32_t dim, uint32_t seed) {
  if (sobol) {  // ld_sample_1d: scrambles the value, no index shuffle
    uint32_t sd = seed ^ u32_hash(dim);
    return to_unit(owen_scramble(__brev(index), u32_hash(sd)));
  }
  return to_unit(u32_hash(hash_combine(hash_combine(seed, index), dim)));
}

// ---------------------------------------------------------------------
// scene tables in shared memory
// ---------------------------------------------------------------------

struct SceneView {
  const float* tri;   // [T, 9]
  const float* trin;  // [T, 10]
  const float* sph;   // [S, 5]
  const float* mat;   // [K, 17]
  int num_tris, num_spheres, num_materials;
  // The BVH tier's world BVH; `tri` and `trin` are then its slot-order
  // tables, left in global memory
  BvhView bvh;
};

__host__ __device__ __forceinline__ size_t scene_smem_floats(
    int num_tris, int num_spheres, int num_materials) {
  return static_cast<size_t>(num_tris) * (kTriStride + kTrinStride) +
         static_cast<size_t>(num_spheres) * kSphStride +
         static_cast<size_t>(num_materials) * kMatStride;
}

// Copies the tables from global memory into `smem` once per block (at
// most ~15 KB at the caps); every thread of a warp then reads the same
// address, which the shared-memory crossbar broadcasts. The BVH tier
// copies the spheres and materials only: its triangles stay in global
// memory (L2), where the walk reads the few it needs. The caller
// synchronises the block before reading them.
template <bool kBvh = false>
__device__ __forceinline__ SceneView load_scene(const SceneView& g,
                                                float* smem) {
  SceneView s = g;
  const int smem_tris = kBvh ? 0 : g.num_tris;
  float* tri = smem;
  float* trin = tri + smem_tris * kTriStride;
  float* sph = trin + smem_tris * kTrinStride;
  float* mat = sph + g.num_spheres * kSphStride;
  for (int j = threadIdx.x; j < smem_tris * kTriStride; j += blockDim.x)
    tri[j] = g.tri[j];
  for (int j = threadIdx.x; j < smem_tris * kTrinStride; j += blockDim.x)
    trin[j] = g.trin[j];
  for (int j = threadIdx.x; j < g.num_spheres * kSphStride; j += blockDim.x)
    sph[j] = g.sph[j];
  for (int j = threadIdx.x; j < g.num_materials * kMatStride;
       j += blockDim.x)
    mat[j] = g.mat[j];
  if constexpr (!kBvh) {
    s.tri = tri;
    s.trin = trin;
  }
  s.sph = sph;
  s.mat = mat;
  return s;
}

// ---------------------------------------------------------------------
// nested-dielectric medium stack (core/medium.py, megakernel.py:225-358)
// ---------------------------------------------------------------------

constexpr int kStackDepth = 8;           // participatingMediumStack[8]
constexpr int kEmptyPrio = 0x7FFFFFFF;   // the empty medium's priority
constexpr int kNoMedium = -1;            // the empty medium's id

struct Medium {
  float ior;
  V3 ab;  // absorption
  int prio, mid;
};

__device__ __forceinline__ Medium empty_medium() {
  return {1.0f, {0.0f, 0.0f, 0.0f}, kEmptyPrio, kNoMedium};
}

// Field by field, so that no address is selected and the media stay in
// registers.
__device__ __forceinline__ Medium sel_medium(bool c, const Medium& a,
                                             const Medium& b) {
  return {c ? a.ior : b.ior, sel3(c, a.ab, b.ab), c ? a.prio : b.prio,
          c ? a.mid : b.mid};
}

// One ray's stack, sorted by descending priority from slot 0 up; the top
// is slot size - 1. It is kept field by field (per-slot arrays, as the
// Pallas `_Stack` keeps per-slot lists), every loop is unrolled over the
// 8 slots, and every update is a select between values at constant
// indices, so the slots can live in registers. Push and pop are the
// masked shifts of `_Stack`, slot for slot (slots at or above `size` hold
// whatever the shifts leave there and are never read).
struct MediumStack {
  float ior[kStackDepth], abx[kStackDepth], aby[kStackDepth],
      abz[kStackDepth];
  int prio[kStackDepth], mid[kStackDepth];
  int size;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < kStackDepth; ++k) {
      ior[k] = 1.0f;
      abx[k] = aby[k] = abz[k] = 0.0f;
      prio[k] = kEmptyPrio;
      mid[k] = kNoMedium;
    }
    size = 0;
  }

  // get_top_ray_medium (compute:647-654)
  __device__ __forceinline__ Medium top() const {
    Medium out = empty_medium();
    const int idx = size - 1;
#pragma unroll
    for (int k = 0; k < kStackDepth; ++k) {
      const bool sel = idx == k;
      out.ior = sel ? ior[k] : out.ior;
      out.ab.x = sel ? abx[k] : out.ab.x;
      out.ab.y = sel ? aby[k] : out.ab.y;
      out.ab.z = sel ? abz[k] : out.ab.z;
      out.prio = sel ? prio[k] : out.prio;
      out.mid = sel ? mid[k] : out.mid;
    }
    return out;
  }

  // determine_true_medium_hit (compute:656-665)
  __device__ __forceinline__ bool is_true_hit(int p) const {
    return size == 0 || p <= top().prio;
  }

  // add_to_medium_stack (compute:582-622): at the top when prio <= the
  // top's (the empty stack's top is 2^31 - 1), else at the count of
  // strictly greater entries; a full stack drops the push.
  __device__ __forceinline__ void push(const Medium& m, bool mask) {
    const bool can = mask && size < kStackDepth;
    int idx = 0;
#pragma unroll
    for (int k = 0; k < kStackDepth; ++k) {
      idx += (k < size && prio[k] > m.prio) ? 1 : 0;
    }
    idx = m.prio <= top().prio ? size : idx;
    // top down, so slot k - 1 still holds its old value
#pragma unroll
    for (int k = kStackDepth - 1; k >= 0; --k) {
      const bool wr = can && k == idx;
      const bool up = can && k > idx;
      const int j = k > 0 ? k - 1 : 0;
      ior[k] = wr ? m.ior : (up ? ior[j] : ior[k]);
      abx[k] = wr ? m.ab.x : (up ? abx[j] : abx[k]);
      aby[k] = wr ? m.ab.y : (up ? aby[j] : aby[k]);
      abz[k] = wr ? m.ab.z : (up ? abz[j] : abz[k]);
      prio[k] = wr ? m.prio : (up ? prio[j] : prio[k]);
      mid[k] = wr ? m.mid : (up ? mid[j] : mid[k]);
    }
    size += can ? 1 : 0;
  }

  // pop_from_medium_stack (compute:627-642): remove the lowest slot with
  // id `id`, shifting the ones above it down (the last slot takes the
  // old slot 0, as the wrapping shift does); a missing id is a no-op.
  __device__ __forceinline__ void pop_id(int id, bool mask) {
    int first = kStackDepth;
#pragma unroll
    for (int k = kStackDepth - 1; k >= 0; --k) {
      first = (k < size && mid[k] == id) ? k : first;
    }
    const bool found = first < kStackDepth;
    const bool go = mask && found;
    const float ior0 = ior[0], abx0 = abx[0], aby0 = aby[0], abz0 = abz[0];
    const int prio0 = prio[0], mid0 = mid[0];
    // bottom up, so slot k + 1 still holds its old value
#pragma unroll
    for (int k = 0; k < kStackDepth; ++k) {
      const bool dead = go && k == size - 1;
      const bool down = go && k >= first;
      const bool last = k == kStackDepth - 1;
      const int j = last ? k : k + 1;
      ior[k] = dead ? 1.0f : (down ? (last ? ior0 : ior[j]) : ior[k]);
      abx[k] = dead ? 0.0f : (down ? (last ? abx0 : abx[j]) : abx[k]);
      aby[k] = dead ? 0.0f : (down ? (last ? aby0 : aby[j]) : aby[k]);
      abz[k] = dead ? 0.0f : (down ? (last ? abz0 : abz[j]) : abz[k]);
      prio[k] = dead ? kEmptyPrio : (down ? (last ? prio0 : prio[j]) : prio[k]);
      mid[k] = dead ? kNoMedium : (down ? (last ? mid0 : mid[j]) : mid[k]);
    }
    size -= go ? 1 : 0;
  }
};

// ---------------------------------------------------------------------
// one bounce of one path
// ---------------------------------------------------------------------

struct PathConfig {
  float far;
  int max_bounces, lim_d, lim_g, lim_t;
  bool sobol, use_rr;
  // env NEE: [H * W, 10] draw table (alias_p, alias_j, pdf, alias pdf,
  // texel radiance rgb, alias radiance rgb) of an H x W map
  const float* env_tab = nullptr;
  int env_h = 0, env_w = 0;
};

constexpr uint32_t kDimEnvNeeBase = 1u << 16;  // sobol.DIM_ENV_NEE_BASE

struct PathState {
  V3 o, d;
  V3 color = {0.0f, 0.0f, 0.0f};
  V3 atten = {1.0f, 1.0f, 1.0f};
  V3 matten = {0.0f, 0.0f, 0.0f};  // attenuation at the miss (deferred sky)
  int n_diffuse = 0, n_glossy = 0, n_transmit = 0;
  float acc_rough = 0.0f;
  MediumStack stack;  // transmissive variants only
  // env NEE: the previous bounce's continuation pdf and NEE flag, and
  // their values at the miss (read by the deferred sky pass)
  float prev_pcos = 0.0f, m_pcos = 0.0f;
  bool prev_nee = false, m_nee = false;
};

// What a shaded bounce leaves for the adjoint's reverse sweep
// (`adjoint.py:447-456`): the attenuation before the bounce, the hit
// material, the lobe, whether the bounce refracted or passed through a
// false hit (its scatter color is 1), whether Beer-Lambert applied and
// the material of the medium it came from, the hit distance and whether
// Russian roulette let the path go on.
struct BounceRecord {
  V3 a_prev;
  int mat, ab_mat;
  float t_safe;
  bool spec, refr, is_true, absorbing, survive;
};

enum BounceResult {
  kEnded = 0,         // nothing shaded: over a bounce limit, or a miss
  kShadedEnded = 1,   // shaded, then killed by Russian roulette
  kShadedGoesOn = 2,  // shaded, the path goes on
};

// Beer-Lambert factor of a bounce: exp(-absorption * t) on absorbing
// lanes, 1 elsewhere. `ab` is the absorbing medium's absorption.
__device__ __forceinline__ V3 beer_factor(V3 ab, bool absorbing,
                                          float t_safe) {
  if (!absorbing) return {1.0f, 1.0f, 1.0f};
  return {expf(-ab.x * t_safe), expf(-ab.y * t_safe), expf(-ab.z * t_safe)};
}

__device__ __forceinline__ V3 mat_absorption(const float* m) {
  return {m[13], m[14], m[15]};
}

// The lobe's color: specular or albedo (compute:691-704).
__device__ __forceinline__ V3 lobe_color(const float* m, bool spec) {
  return spec ? V3{m[4], m[5], m[6]} : V3{m[0], m[1], m[2]};
}

// Solid-angle pdf of the procedural glossy lobe normalize(lerp(mirror,
// dd, a1)), dd cosine-distributed (core.math.procedural_glossy_pdf;
// megakernel.py:918-943).
__device__ __forceinline__ float glossy_pdf(V3 w, V3 mr, float a1, V3 n) {
  const float eps = 1e-6f;
  const float b = (1.0f - a1) * (w.x * mr.x + w.y * mr.y + w.z * mr.z);
  const float c = (1.0f - a1) * (1.0f - a1) - a1 * a1;
  const float disc = b * b - c;
  const bool exists = a1 > eps && disc >= 0.0f;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float a_safe = fmaxf(a1, eps);
  float total = 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float t = r == 0 ? b - sq : b + sq;
    const bool valid = exists && t > eps;
    const float ts = valid ? t : 1.0f;
    const V3 dd = {(w.x * ts - (1.0f - a_safe) * mr.x) / a_safe,
                   (w.y * ts - (1.0f - a_safe) * mr.y) / a_safe,
                   (w.z * ts - (1.0f - a_safe) * mr.z) / a_safe};
    const float cos_dd = fmaxf(dot3(dd, n), 0.0f);
    const float dens = cos_dd * kInvPi * ts * ts /
                       (a_safe * a_safe * fmaxf(fabsf(dot3(w, dd)), eps));
    total = total + (valid ? dens : 0.0f);
  }
  return total;
}

// Whether a shadow ray reaches `far` unoccluded (megakernel.py:1405-1474):
// the closest hit's tests without its payload, and the
// mesh-beats-sphere-by-HIT_EPS rule, sh_t >= far with sh_t the mesh hit
// if it beats the sphere hit by HIT_EPS inside far, else the sphere hit.
// A sphere hit inside far occludes either way; past it, a triangle
// occludes iff its t < min(far, sphere t - HIT_EPS). So the BVH tier
// stops at the first triangle under that bound (an any-hit walk, the
// raylet tier's occlusion mode, megakernel.py:749-752, :1449), which
// gives the brute tier's decision.
template <bool kBvh>
__device__ __forceinline__ bool shadow_visible(const SceneView& sc, V3 o,
                                               V3 d, float far) {
  const V3 inv_d = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  float ssp_t = INFINITY;
  for (int si = 0; si < sc.num_spheres; ++si) {
    bool inside;
    ssp_t = fminf(ssp_t,
                  sphere_t(sc.sph + si * kSphStride, o, d, inv_d, far, inside));
  }
  if constexpr (kBvh) {
    if (ssp_t < far) return false;
    BvhHit h = {fminf(far, ssp_t - kHitEps), 0.0f, 0.0f, 0.0f, -1, 0, 0};
    return !bvh_walk<true, false>(sc.bvh, o, d, h);
  } else {
    float str_t = INFINITY;
    for (int ti = 0; ti < sc.num_tris; ++ti) {
      float t, u, v, det;
      if (triangle_hit(sc.tri + ti * kTriStride, o, d, t, u, v, det) &&
          t < str_t)
        str_t = t;
    }
    const float sh_t =
        (str_t < ssp_t - kHitEps && str_t < far) ? str_t : ssp_t;
    return sh_t >= far;
  }
}

// Advances `s` by bounce k of the path (trace_ray compute:876-950) and
// fills `rec` when the bounce shades. The caller stops at any result but
// kShadedGoesOn: every later update of the Pallas body is masked for a
// dead ray, so its state is frozen and leaving the loop is exact.
template <bool kTransmissive, bool kEnvNee, bool kBvh = false>
__device__ __forceinline__ int path_bounce(const SceneView& sc,
                                           const PathConfig& cfg,
                                           uint32_t sidx, uint32_t seed,
                                           int k, PathState& s,
                                           BounceRecord& rec) {
  // --- per-type termination (compute:869-871, `>` semantics)
  const int n_transmit = kTransmissive ? s.n_transmit : 0;  // opaque: 0
  if (s.n_diffuse > cfg.lim_d || s.n_glossy > cfg.lim_g ||
      n_transmit > cfg.lim_t)
    return kEnded;

  const V3 o = s.o, d = s.d;
  const float far = cfg.far;
  const V3 inv_d = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};

  // --- spheres: linear scan, AABB pre-test vs far, first-min winner
  float sp_t = INFINITY, sp_orient = 1.0f;
  V3 sp_c = {0.0f, 0.0f, 0.0f};
  float sp_mat = 0.0f;
  for (int si = 0; si < sc.num_spheres; ++si) {
    const float* sp = sc.sph + si * kSphStride;
    bool inside;
    const float t = sphere_t(sp, o, d, inv_d, far, inside);
    if (t < sp_t) {
      sp_t = t;
      sp_orient = inside ? -1.0f : 1.0f;
      sp_c = {sp[0], sp[1], sp[2]};
      sp_mat = sp[4];
    }
  }

  // --- triangles: Möller-Trumbore with inline winner payload
  float tr_t = INFINITY, tr_s = 0.0f, tr_mat = 0.0f;
  V3 tr_n = {0.0f, 0.0f, 0.0f};
  if constexpr (kBvh) {
    // B1d: the world-BVH walk, its best t seeded with min(far, sphere hit
    // - HIT_EPS) (megakernel.py:1138-1139): a triangle that wins there is
    // the one the brute scan's mesh-beats-sphere rule would take
    BvhHit h = {fminf(far, sp_t - kHitEps), 0.0f, 0.0f, 0.0f, -1, 0, 0};
    if (bvh_walk<false, false>(sc.bvh, o, d, h)) {
      const float* tn = sc.trin + static_cast<size_t>(h.slot) * kTrinStride;
      tr_t = h.t;
      tr_s = sign_of(h.det);
      tr_n = {__ldg(tn) + __ldg(tn + 3) * h.u + __ldg(tn + 6) * h.v,
              __ldg(tn + 1) + __ldg(tn + 4) * h.u + __ldg(tn + 7) * h.v,
              __ldg(tn + 2) + __ldg(tn + 5) * h.u + __ldg(tn + 8) * h.v};
      tr_mat = __ldg(tn + 9);
    }
  } else {
    for (int ti = 0; ti < sc.num_tris; ++ti) {
      float t, u, v, det;
      if (triangle_hit(sc.tri + ti * kTriStride, o, d, t, u, v, det) &&
          t < tr_t) {
        const float* tn = sc.trin + ti * kTrinStride;
        tr_t = t;
        tr_s = sign_of(det);
        tr_n = {tn[0] + tn[3] * u + tn[6] * v, tn[1] + tn[4] * u + tn[7] * v,
                tn[2] + tn[5] * u + tn[8] * v};
        tr_mat = tn[9];
      }
    }
  }

  // --- resolve winner: mesh beats sphere by HIT_EPS, inside far
  const bool mesh_wins = (tr_t < sp_t - kHitEps) && (tr_t < far);
  const float t = mesh_wins ? tr_t : sp_t;
  const bool is_hit = t < far;
  const float t_safe = fabsf(t) < INFINITY ? t : 0.0f;  // isfinite
  const V3 pos = {o.x + d.x * t_safe, o.y + d.y * t_safe,
                  o.z + d.z * t_safe};
  const V3 tri_n = normalize3({tr_n.x * tr_s, tr_n.y * tr_s, tr_n.z * tr_s},
                              1e-20f);
  const V3 sph_n = normalize3({(pos.x - sp_c.x) * sp_orient,
                               (pos.y - sp_c.y) * sp_orient,
                               (pos.z - sp_c.z) * sp_orient},
                              1e-20f);
  const V3 normal = sel3(mesh_wins, tri_n, sph_n);
  const float orient = mesh_wins ? tr_s : sp_orient;
  const int mat_id = static_cast<int>(mesh_wins ? tr_mat : sp_mat);
  const float* m = sc.mat + mat_id * kMatStride;
  const float metallic = m[7], roughness = m[8];
  const V3 em = {m[9], m[10], m[11]};
  const float ior = m[12];

  // --- miss: record the deferred-sky attenuation (and with env NEE the
  // previous bounce's MIS state, megakernel.py:1547-1553); the ray dies
  if (!is_hit) {
    s.matten = s.atten;
    if constexpr (kEnvNee) {
      s.m_pcos = s.prev_pcos;
      s.m_nee = s.prev_nee;
    }
    return kEnded;
  }

  // --- emission before BRDF (compute:901-902)
  s.color = {s.color.x + em.x * s.atten.x, s.color.y + em.y * s.atten.y,
             s.color.z + em.z * s.atten.z};

  // --- sampler draws for this bounce (dims = base + 5k, compute:921)
  const uint32_t stride = 5u * static_cast<uint32_t>(k);
  float r1u, r1v, p1u, p1v;
  sample_2d(cfg.sobol, sidx, 2u + stride, seed, &r1u, &r1v);
  sample_2d(cfg.sobol, sidx, 3u + stride, seed, &p1u, &p1v);
  const float rr = sample_1d(cfg.sobol, sidx, 4u + stride, seed);

  const bool entering = orient > 0.0f;
  float cur_ior, hit_ior;
  Medium cur;       // the medium the ray travelled through (transmissive)
  bool true_hit = true;
  if constexpr (kTransmissive) {
    // interface tracking (evaluate_material_hit, compute:743-817)
    const int prio = static_cast<int>(m[16]);
    const Medium internal = {ior, mat_absorption(m), prio, mat_id};
    const bool uses_tracking = prio >= 0;  // compute:758
    true_hit = !uses_tracking || s.stack.is_true_hit(prio);
    const Medium top0 = s.stack.top();
    const bool empty0 = s.stack.size == 0;
    s.stack.pop_id(mat_id, uses_tracking && !entering);
    const Medium top_ap = s.stack.top();
    cur = sel_medium(entering, top0,
                     sel_medium(uses_tracking,
                                sel_medium(empty0, internal, top0),
                                internal));
    const Medium hitm = sel_medium(entering, internal,
                                   sel_medium(uses_tracking, top_ap, top0));
    s.stack.push(internal, uses_tracking && entering);
    cur_ior = cur.ior;
    hit_ior = hitm.ior;
  } else {
    cur_ior = entering ? 1.0f : ior;
    hit_ior = entering ? ior : 1.0f;
  }

  // uniform unit vector (HalogenRandom.hlsl:282-298)
  const float theta = r1u * kTwoPi;
  const float cos_phi = 2.0f * r1v - 1.0f;
  const float sin_phi = sqrtf(fmaxf(0.0f, 1.0f - cos_phi * cos_phi));
  const V3 rv = {sin_phi * cosf(theta), sin_phi * sinf(theta), cos_phi};

  // lambertian scatter (compute:491-501)
  V3 sdir = {normal.x + rv.x, normal.y + rv.y, normal.z + rv.z};
  if (dot3(sdir, sdir) < 1e-16f) sdir = normal;
  const V3 diffuse_dir = normalize3(sdir, 0.0f);

  // fresnel specular probability (compute:519-540)
  float r0 = (cur_ior - hit_ior) / (cur_ior + hit_ior);
  r0 = r0 * r0;
  float cos_x = -(normal.x * d.x + normal.y * d.y + normal.z * d.z);
  const float nr = cur_ior / hit_ior;
  const float sin_t2 = nr * nr * (1.0f - cos_x * cos_x);
  const bool exiting = cur_ior > hit_ior;
  const bool tir = exiting && sin_t2 > 1.0f;
  if (exiting) cos_x = sqrtf(fmaxf(0.0f, 1.0f - sin_t2));
  const float xs = 1.0f - cos_x;
  const float fres = r0 + (1.0f - r0) * xs * xs * xs * xs * xs;
  float schlick = metallic + (1.0f - metallic) * fres;
  if (tir) schlick = 1.0f;
  const float spec_prob = metallic > 0.0f ? schlick : metallic;
  const bool do_spec = p1v < spec_prob;

  // reflect + roughness^2 lerp toward diffuse (compute:691-704)
  const float r2 = roughness * roughness;
  const float dn = dot3(d, normal);
  const V3 refl = {d.x - 2.0f * dn * normal.x, d.y - 2.0f * dn * normal.y,
                   d.z - 2.0f * dn * normal.z};
  const V3 spec_dir = {refl.x + (diffuse_dir.x - refl.x) * r2,
                       refl.y + (diffuse_dir.y - refl.y) * r2,
                       refl.z + (diffuse_dir.z - refl.z) * r2};
  const V3 refl_org = {pos.x + normal.x * kOffsetEps,
                       pos.y + normal.y * kOffsetEps,
                       pos.z + normal.z * kOffsetEps};

  V3 new_dir, new_org, sc_at;
  int bounce_type;  // 0 diffuse, 1 glossy, 2 transmissive
  bool absorbing, do_refr = false;
  int ab_mat = mat_id;  // material of the absorbing medium
  if constexpr (kTransmissive) {
    // --- refraction branch (material_BRDF, compute:711-734)
    do_refr = p1u > m[3];  // alpha
    const float cos_t = fminf(-dn, 1.0f);
    const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
    const float eta = cur_ior / hit_ior;
    const bool tir_r = eta * sin_t > 1.0f;
    const V3 rp = {eta * (d.x + cos_t * normal.x),
                   eta * (d.y + cos_t * normal.y),
                   eta * (d.z + cos_t * normal.z)};
    const float par = -sqrtf(fabsf(1.0f - dot3(rp, rp)));
    V3 refr = {rp.x + par * normal.x, rp.y + par * normal.y,
               rp.z + par * normal.z};
    refr = sel3(tir_r, refl, refr);
    const V3 flip_n = sel3(tir_r, normal, V3{-normal.x, -normal.y, -normal.z});
    V3 sdir_r = {flip_n.x + rv.x, flip_n.y + rv.y, flip_n.z + rv.z};
    if (dot3(sdir_r, sdir_r) < 1e-16f) sdir_r = flip_n;
    const V3 diff_refr = normalize3(sdir_r, 0.0f);
    const V3 refr_dir = {refr.x + (diff_refr.x - refr.x) * r2,
                         refr.y + (diff_refr.y - refr.y) * r2,
                         refr.z + (diff_refr.z - refr.z) * r2};
    const V3 refr_org = {pos.x - normal.x * kOffsetEps,
                         pos.y - normal.y * kOffsetEps,
                         pos.z - normal.z * kOffsetEps};
    const V3 one = {1.0f, 1.0f, 1.0f};
    if (true_hit) {
      new_dir = normalize3(
          sel3(do_refr, refr_dir, sel3(do_spec, spec_dir, diffuse_dir)),
          1e-20f);
      new_org = sel3(do_refr, refr_org, refl_org);
      sc_at = do_refr ? one : lobe_color(m, do_spec);
      bounce_type = do_refr ? 2 : (do_spec ? 1 : 0);
    } else {
      // false hit: pass through behind the surface, counts as
      // transmissive (compute:803-808)
      new_dir = d;
      new_org = refr_org;
      sc_at = one;
      bounce_type = 2;
    }
    // bandaid pop (compute:799-802)
    s.stack.pop_id(mat_id, true_hit && entering && bounce_type != 2);
    // Beer-Lambert through the current medium (compute:810-813)
    absorbing = cur.mid != kNoMedium;
    ab_mat = cur.mid;
    sc_at = mul3(sc_at, beer_factor(cur.ab, absorbing, t_safe));
  } else {
    new_dir = normalize3(sel3(do_spec, spec_dir, diffuse_dir), 1e-20f);
    new_org = refl_org;
    bounce_type = do_spec ? 1 : 0;
    // lobe color times Beer-Lambert on exiting lanes (compute:810-813);
    // x*1 is exact, so entering lanes keep the lobe color unchanged
    absorbing = !entering;
    sc_at = mul3(lobe_color(m, do_spec),
                 beer_factor(mat_absorption(m), absorbing, t_safe));
  }

  if constexpr (kEnvNee) {
    // --- envmap next-event estimation + MIS (megakernel.py:1380-1504)
    // on opaque lobes. The draw: sampler dims DIM_ENV_NEE_BASE + 5k, the
    // alias step on one row of the draw table (envmap.sample_env_draw).
    float nu, nv;
    sample_2d(cfg.sobol, sidx, kDimEnvNeeBase + stride, seed, &nu, &nv);
    const int n_tex = cfg.env_h * cfg.env_w;
    const float rn = fminf(fmaxf(nu, 0.0f), 0.99999988f) *
                     static_cast<float>(n_tex);
    const int idx = min(max(static_cast<int>(rn), 0), n_tex - 1);
    const float* row = cfg.env_tab + 10 * static_cast<size_t>(idx);
    const bool stay = nv < __ldg(row);
    const float* alt = row + 3;  // alias pdf at [3], its radiance at [7:10]
    const int texel = stay ? idx : static_cast<int>(__ldg(row + 1));
    const float lpdf = __ldg(stay ? row + 2 : alt);
    const V3 rad = {__ldg((stay ? row : alt) + 4), __ldg((stay ? row : alt) + 5),
                    __ldg((stay ? row : alt) + 6)};
    const int rowi = texel / cfg.env_w;
    const int col = texel - rowi * cfg.env_w;
    const float th = (static_cast<float>(rowi) + 0.5f) /
                     static_cast<float>(cfg.env_h) * kPi;
    const float ph = ((static_cast<float>(col) + 0.5f) /
                          static_cast<float>(cfg.env_w) -
                      0.5f) * 2.0f * kPi;
    const float sin_th = sinf(th);
    const V3 ld = {sin_th * sinf(ph), cosf(th), -sin_th * cosf(ph)};

    const float ps = spec_prob;
    const bool surf = m[3] >= 1.0f;
    const float cos_l = dot3(normal, ld);
    const bool cand = surf && cos_l > 0.0f && lpdf > 1e-12f;
    if (cand) {
      const V3 sh_o = {pos.x + normal.x * 1e-4f, pos.y + normal.y * 1e-4f,
                       pos.z + normal.z * 1e-4f};
      if (shadow_visible<kBvh>(sc, sh_o, ld, far)) {
        const float p_gl_l = glossy_pdf(ld, refl, r2, normal);
        const float p_mix_l =
            (1.0f - ps) * fmaxf(cos_l, 0.0f) * kInvPi + ps * p_gl_l;
        const float w_fac = lpdf / (lpdf + p_mix_l) / fmaxf(lpdf, 1e-12f);
        const float dterm = (1.0f - ps) * cos_l * kInvPi;
        const float gterm = ps * p_gl_l;
        s.color = {
            s.color.x + s.atten.x * (m[0] * dterm + m[4] * gterm) * rad.x * w_fac,
            s.color.y + s.atten.y * (m[1] * dterm + m[5] * gterm) * rad.y * w_fac,
            s.color.z + s.atten.z * (m[2] * dterm + m[6] * gterm) * rad.z * w_fac};
      }
    }
    // continuation-strategy pdf for the next bounce's MIS
    const float cos_nd = dot3(normal, new_dir);
    const bool covered = surf && cos_nd > 0.0f && bounce_type != 2 &&
                         !(bounce_type == 1 && r2 <= 1e-6f);
    s.prev_pcos = covered ? (1.0f - ps) * fmaxf(cos_nd, 0.0f) * kInvPi +
                                ps * glossy_pdf(new_dir, refl, r2, normal)
                          : 0.0f;
    s.prev_nee = covered;
  }

  rec.a_prev = s.atten;
  rec.mat = mat_id;
  rec.ab_mat = ab_mat;
  rec.t_safe = t_safe;
  rec.spec = do_spec && !do_refr;
  rec.refr = bounce_type == 2;
  rec.is_true = true_hit;
  rec.absorbing = absorbing;
  rec.survive = true;

  s.o = new_org;
  s.d = new_dir;
  s.atten = mul3(s.atten, sc_at);
  if (bounce_type == 0) {
    ++s.n_diffuse;
  } else if (bounce_type == 1) {
    ++s.n_glossy;
  } else {
    ++s.n_transmit;
  }
  // roughness accumulator quirk: scalar += roughness * atten.x
  s.acc_rough = s.acc_rough + roughness * s.atten.x;

  // --- Russian roulette (compute:923-936): 1/p after the kill test
  if (cfg.use_rr) {
    const float contribution =
        fmaxf(fmaxf(s.atten.x, s.atten.y), s.atten.z);
    if (rr > contribution) {
      rec.survive = false;
      return kShadedEnded;
    }
    const float inv_c = 1.0f / fmaxf(contribution, 1e-20f);
    s.atten = {s.atten.x * inv_c, s.atten.y * inv_c, s.atten.z * inv_c};
  }
  return kShadedGoesOn;
}

}  // namespace halogen
