// The path of one ray, shared by the forward megakernel (megakernel.cu)
// and its adjoint (adjoint.cu).
//
// Both kernels trace a ray through `path_bounce`, the bounce body of the
// brute-force, opaque, no-NEE tier of the Pallas megakernel
// (`halogen_tpu/kernels/megakernel.py:1073-1554`): sampler draws, closest
// hit against every sphere and triangle, emission, the opaque BRDF,
// per-type bounce limits, Russian roulette and the deferred-miss record.
// Because the code is one, and both files are built with the same flags
// (-fmad=false, no fast math), the adjoint's replay takes the forward
// kernel's path bit for bit; a copy that drifted by one ulp could flip a
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

namespace halogen {

constexpr int kThreads = 128;
constexpr int kTriStride = 9;    // v0, e1, e2
constexpr int kTrinStride = 10;  // n0, n1 - n0, n2 - n0, material
constexpr int kSphStride = 5;    // center, radius, material
constexpr int kMatStride = 17;   // see megakernel.py::_scene_tables
constexpr float kHitEps = 1e-4f;
constexpr float kOffsetEps = 1e-4f;
constexpr float kDetEps = 1e-8f;
constexpr float kTwoPi = 6.28318530717958647692f;
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

__device__ __forceinline__ V3 normalize3(V3 v, float eps) {
  float n = sqrtf(dot3(v, v));
  float inv = 1.0f / fmaxf(n, eps);
  return {v.x * inv, v.y * inv, v.z * inv};
}

__device__ __forceinline__ V3 sel3(bool c, V3 a, V3 b) { return c ? a : b; }

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float safe_inv(float c) {
  const float tiny = 1e-30f;
  return 1.0f / (fabsf(c) < tiny ? tiny : c);
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
};

__host__ __device__ __forceinline__ size_t scene_smem_floats(
    int num_tris, int num_spheres, int num_materials) {
  return static_cast<size_t>(num_tris) * (kTriStride + kTrinStride) +
         static_cast<size_t>(num_spheres) * kSphStride +
         static_cast<size_t>(num_materials) * kMatStride;
}

// Copies the tables from global memory into `smem` once per block (at
// most ~15 KB at the caps); every thread of a warp then reads the same
// address, which the shared-memory crossbar broadcasts. The caller
// synchronises the block before reading them.
__device__ __forceinline__ SceneView load_scene(const SceneView& g,
                                                float* smem) {
  SceneView s = g;
  float* tri = smem;
  float* trin = tri + g.num_tris * kTriStride;
  float* sph = trin + g.num_tris * kTrinStride;
  float* mat = sph + g.num_spheres * kSphStride;
  for (int j = threadIdx.x; j < g.num_tris * kTriStride; j += blockDim.x)
    tri[j] = g.tri[j];
  for (int j = threadIdx.x; j < g.num_tris * kTrinStride; j += blockDim.x)
    trin[j] = g.trin[j];
  for (int j = threadIdx.x; j < g.num_spheres * kSphStride; j += blockDim.x)
    sph[j] = g.sph[j];
  for (int j = threadIdx.x; j < g.num_materials * kMatStride;
       j += blockDim.x)
    mat[j] = g.mat[j];
  s.tri = tri;
  s.trin = trin;
  s.sph = sph;
  s.mat = mat;
  return s;
}

// ---------------------------------------------------------------------
// one bounce of one path
// ---------------------------------------------------------------------

struct PathConfig {
  float far;
  int max_bounces, lim_d, lim_g, lim_t;
  bool sobol, use_rr;
};

struct PathState {
  V3 o, d;
  V3 color = {0.0f, 0.0f, 0.0f};
  V3 atten = {1.0f, 1.0f, 1.0f};
  V3 matten = {0.0f, 0.0f, 0.0f};  // attenuation at the miss (deferred sky)
  int n_diffuse = 0, n_glossy = 0;
  float acc_rough = 0.0f;
};

// What a shaded bounce leaves for the adjoint's reverse sweep
// (`adjoint.py:447-456`): the attenuation before the bounce, the hit
// material, the lobe, whether Beer-Lambert applied (an exiting hit), the
// hit distance and whether Russian roulette let the path go on.
struct BounceRecord {
  V3 a_prev;
  int mat;
  float t_safe;
  bool spec, absorbing, survive;
};

enum BounceResult {
  kEnded = 0,         // nothing shaded: over a bounce limit, or a miss
  kShadedEnded = 1,   // shaded, then killed by Russian roulette
  kShadedGoesOn = 2,  // shaded, the path goes on
};

// Beer-Lambert factor of a bounce: exp(-absorption * t) on exiting hits,
// 1 elsewhere. `m` is the material row.
__device__ __forceinline__ V3 beer_factor(const float* m, bool absorbing,
                                          float t_safe) {
  if (!absorbing) return {1.0f, 1.0f, 1.0f};
  return {expf(-m[13] * t_safe), expf(-m[14] * t_safe),
          expf(-m[15] * t_safe)};
}

// The lobe's color: specular or albedo (compute:691-704).
__device__ __forceinline__ V3 lobe_color(const float* m, bool spec) {
  return spec ? V3{m[4], m[5], m[6]} : V3{m[0], m[1], m[2]};
}

// Advances `s` by bounce k of the path (trace_ray compute:876-950) and
// fills `rec` when the bounce shades. The caller stops at any result but
// kShadedGoesOn: every later update of the Pallas body is masked for a
// dead ray, so its state is frozen and leaving the loop is exact.
__device__ __forceinline__ int path_bounce(const SceneView& sc,
                                           const PathConfig& cfg,
                                           uint32_t sidx, uint32_t seed,
                                           int k, PathState& s,
                                           BounceRecord& rec) {
  // --- per-type termination (compute:869-871, `>` semantics)
  const int n_transmit = 0;  // opaque scenes never refract
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
    const bool inside = t_near < 0.0f;
    float t = inside ? t_far : t_near;
    const float orient = inside ? -1.0f : 1.0f;
    t = disc >= 0.0f ? t : INFINITY;
    t = (aabb_t < far && t > kHitEps) ? t : INFINITY;
    if (t < sp_t) {
      sp_t = t;
      sp_orient = orient;
      sp_c = {cx, cy, cz};
      sp_mat = sp[4];
    }
  }

  // --- triangles: Möller-Trumbore with inline winner payload
  float tr_t = INFINITY, tr_s = 0.0f, tr_mat = 0.0f;
  V3 tr_n = {0.0f, 0.0f, 0.0f};
  for (int ti = 0; ti < sc.num_tris; ++ti) {
    const float* tv = sc.tri + ti * kTriStride;
    const V3 v0 = {tv[0], tv[1], tv[2]};
    const V3 e1 = {tv[3], tv[4], tv[5]};
    const V3 e2 = {tv[6], tv[7], tv[8]};
    const V3 pvec = cross3(d, e2);
    const float det = dot3(pvec, e1);
    const bool parallel = fabsf(det) < kDetEps;
    const float inv_det = 1.0f / (parallel ? 1.0f : det);
    const V3 tvec = {o.x - v0.x, o.y - v0.y, o.z - v0.z};
    const float u = dot3(tvec, pvec) * inv_det;
    const V3 qvec = cross3(tvec, e1);
    const float v = dot3(d, qvec) * inv_det;
    const float t = dot3(e2, qvec) * inv_det;
    const bool ok = !parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                    u + v <= 1.0f && t > 0.0f && t > kHitEps && t < tr_t;
    if (ok) {
      const float* tn = sc.trin + ti * kTrinStride;
      tr_t = t;
      tr_s = sign_of(det);
      tr_n = {tn[0] + tn[3] * u + tn[6] * v, tn[1] + tn[4] * u + tn[7] * v,
              tn[2] + tn[5] * u + tn[8] * v};
      tr_mat = tn[9];
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

  // --- miss: record the deferred-sky attenuation, the ray dies
  if (!is_hit) {
    s.matten = s.atten;
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
  (void)p1u;  // refraction draw: never taken in opaque scenes

  const bool entering = orient > 0.0f;
  const float cur_ior = entering ? 1.0f : ior;
  const float hit_ior = entering ? ior : 1.0f;

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
  const V3 new_dir = normalize3(sel3(do_spec, spec_dir, diffuse_dir),
                                1e-20f);
  const V3 new_org = {pos.x + normal.x * kOffsetEps,
                      pos.y + normal.y * kOffsetEps,
                      pos.z + normal.z * kOffsetEps};
  // lobe color times Beer-Lambert on exiting lanes (compute:810-813); x*1
  // is exact, so entering lanes keep the lobe color unchanged
  const bool absorbing = !entering;
  const V3 sc_at = mul3(lobe_color(m, do_spec),
                        beer_factor(m, absorbing, t_safe));

  rec.a_prev = s.atten;
  rec.mat = mat_id;
  rec.t_safe = t_safe;
  rec.spec = do_spec;
  rec.absorbing = absorbing;
  rec.survive = true;

  s.o = new_org;
  s.d = new_dir;
  s.atten = mul3(s.atten, sc_at);
  if (do_spec) {
    ++s.n_glossy;
  } else {
    ++s.n_diffuse;
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
