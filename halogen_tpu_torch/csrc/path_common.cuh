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
//     in global memory. The adjoint's BVH variants (B2+d, B2b+d) replay
//     through it too, or, on the record route, sweep what the forward
//     recorded as it traced (`RecordView`, `record_bounce`);
//   kLightNee (B1e, forward only; the JAX package has no kernel for it:
//     its megakernel refuses light NEE, `megakernel.py:1622-1635`, and
//     runs the lockstep `integrator/trace.py:200-229, 332-432`): one
//     emitter a bounce from the light table by its power CDF, a point on
//     a triangle or a direction in a sphere's cone, a shadow ray that
//     decides as the closest hit would, the balance heuristic against the
//     continuation pdf, and the emission's MIS weight where light NEE
//     covered the previous scatter. Its table is one 64-byte row a light
//     (`LightView`), so a draw is a binary search over the CDF column and
//     four 16-byte loads; the brute tier's shadow ray skips
//     Möller-Trumbore on the triangles whose plane its segment cannot
//     cross (`shadow_tris`).
// With all four off the body is B1a's, op for op. Because the code is one,
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

// ---------------------------------------------------------------------
// uint32 sampler (mirrors sampler/sobol.py and megakernel.py:88-183)
// ---------------------------------------------------------------------

// The hash-based Owen scramble (HalogenRandom.hlsl:140-161) without its two
// bit reversals: owen_scramble(v, s) == __brev(owen_core(__brev(v), s)).
// The draws below compose it so that reversals which meet cancel.
__device__ __forceinline__ uint32_t owen_core(uint32_t x, uint32_t seed) {
  x ^= x * 0x3D20ADEAu;
  x += seed;
  x *= (seed >> 16) | 1u;
  x ^= x * 0x05526C56u;
  x ^= x * 0x53A22864u;
  return x;
}

__device__ __forceinline__ uint32_t u32_hash(uint32_t v) {
  uint32_t state = v * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ uint32_t hash_combine(uint32_t seed, uint32_t v) {
  return seed ^ (v + (seed << 6) + (seed >> 2));
}

// __brev(sobol1d(index, 1)), the bit-reversed Sobol point of dimension 1.
// That dimension's direction numbers are Pascal's triangle mod 2, so the
// product with them is five butterfly steps (sampler/sobol.py
// `sobol_dim1_reversed`) instead of 32 table rows.
__device__ __forceinline__ uint32_t sobol_dim1_reversed(uint32_t index) {
  uint32_t y = index;
  y ^= (y >> 1) & 0x55555555u;
  y ^= (y >> 2) & 0x33333333u;
  y ^= (y >> 4) & 0x0F0F0F0Fu;
  y ^= (y >> 8) & 0x00FF00FFu;
  y ^= (y >> 16) & 0x0000FFFFu;
  return y;
}

__device__ __forceinline__ float to_unit(uint32_t u) {
  return __uint2float_rn(u) * kInvU32;
}

__device__ __forceinline__ void sample_2d(bool sobol, uint32_t index,
                                          uint32_t dim, uint32_t seed,
                                          float* a, float* b) {
  if (sobol) {  // ld_sample_2d
    uint32_t sd = seed ^ u32_hash(dim);
    // owen_scramble(index, sd); dimension 0 of the point is its reversal
    const uint32_t shuffled = __brev(owen_core(__brev(index), sd));
    *a = to_unit(__brev(owen_core(shuffled, hash_combine(sd, 0u))));
    *b = to_unit(__brev(owen_core(sobol_dim1_reversed(shuffled),
                                  hash_combine(sd, 1u))));
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
    return to_unit(__brev(owen_core(index, u32_hash(sd))));
  }
  return to_unit(u32_hash(hash_combine(hash_combine(seed, index), dim)));
}

// ---------------------------------------------------------------------
// primary rays (integrator/camera.py `generate_rays`, trace.py `group_rays`)
// ---------------------------------------------------------------------

constexpr uint32_t kDimFocalDisc = 0u;  // sobol.DIM_FOCAL_DISC
constexpr uint32_t kDimRayJitter = 1u;  // sobol.DIM_RAY_JITTER

// A launch's camera block. With `cam` null the kernel reads explicit rays;
// else thread i makes its own: pixel pix[i / spp_block], lane lane0 +
// i % spp_block of the sample stream of frame `frame`.
struct CameraView {
  const float* cam;       // [24]: cam_to_world row-major [4, 4], half_w,
                          // half_h, near, focal distance, aperture radius,
                          // filter radius, 2 unused
  const long long* pix;   // [n / spp_block] flat pixel ids
  const uint32_t* frame;  // [1]
  int width, height, spp_block, lane0, spp;
};

struct PrimaryRay {
  V3 o, d;
  uint32_t sidx, seed;
};

// sampler/mappings.py inverse_blackman_harris_cdf. PyTorch divides a CUDA
// tensor by a Python number as a product with its float32 reciprocal, and
// so does this (likewise `/ width` and `/ height` below).
__device__ __forceinline__ float inverse_blackman_harris_cdf(float x) {
  const float t = x * 1.99221575606f - 0.99610787803f;
  return 0.5f * logf((1.0f + t) / (1.0f - t)) * (1.0f / 6.24f);
}

// core/math.py normalize without a floor: v / sqrt((x x + y y) + z z)
__device__ __forceinline__ V3 normalize_div(V3 v) {
  const float n = sqrtf(dot3(v, v));
  return {v.x / n, v.y / n, v.z / n};
}

// Row j of `v @ m[:3, :3].T`: PyTorch hands that product to a float32
// GEMM, which sums the three products as a chain of fused multiply-adds.
__device__ __forceinline__ float rotate_row(const float* m, int j, V3 v) {
  return fmaf(v.z, m[4 * j + 2],
              fmaf(v.y, m[4 * j + 1], fmaf(v.x, m[4 * j], 0.0f)));
}

// Ray i of the launch's group: the thin-lens camera with Blackman-Harris
// pixel filtering, float op for float op as `generate_rays` runs on the
// card, with the pixel's seed and the sample index of `group_rays`.
__device__ __forceinline__ PrimaryRay camera_ray(const CameraView& cv,
                                                 bool sobol, int i) {
  const float* c = cv.cam;
  const float half_w = c[16], half_h = c[17], near = c[18];
  const float focal = c[19], aperture = c[20], filter_radius = c[21];
  const int pixel = static_cast<int>(cv.pix[i / cv.spp_block]);
  PrimaryRay r;
  r.seed = u32_hash(static_cast<uint32_t>(pixel));
  r.sidx = cv.frame[0] * static_cast<uint32_t>(cv.spp) +
           static_cast<uint32_t>(cv.lane0 + i % cv.spp_block);
  const float inv_w = 1.0f / static_cast<float>(cv.width);
  const float inv_h = 1.0f / static_cast<float>(cv.height);
  const float px = static_cast<float>(pixel % cv.width);
  const float py = static_cast<float>(pixel / cv.width);
  const float ndc_x = (px + 0.5f) * inv_w * 2.0f - 1.0f;
  const float ndc_y = (py + 0.5f) * inv_h * 2.0f - 1.0f;
  const float px_w = 2.0f * half_w * inv_w;
  const float px_h = 2.0f * half_h * inv_h;
  float ju, jv, au, av;
  sample_2d(sobol, r.sidx, kDimRayJitter, r.seed, &ju, &jv);
  const float jitter_x =
      inverse_blackman_harris_cdf(ju) * 2.0f * filter_radius * px_w;
  const float jitter_y =
      inverse_blackman_harris_cdf(jv) * 2.0f * filter_radius * px_h;
  // camera-space point on the near plane (compute:1002-1003)
  const V3 screen = {ndc_x * half_w + jitter_x, ndc_y * half_h + jitter_y,
                     near};
  // thin lens: aperture point on the focal disc (compute:998-999)
  sample_2d(sobol, r.sidx, kDimFocalDisc, r.seed, &au, &av);
  const float theta = au * kTwoPi;
  const float rad = aperture * av;
  const V3 lens = {cosf(theta) * rad, sinf(theta) * rad, 0.0f};
  // direction through the focal plane (compute:1006-1007)
  const V3 fn = normalize_div(screen);
  const V3 cam_dir = normalize_div(
      {fn.x * focal - lens.x, fn.y * focal - lens.y, fn.z * focal - lens.z});
  r.o = {rotate_row(c, 0, lens) + c[3], rotate_row(c, 1, lens) + c[7],
         rotate_row(c, 2, lens) + c[11]};
  r.d = normalize_div({rotate_row(c, 0, cam_dir), rotate_row(c, 1, cam_dir),
                       rotate_row(c, 2, cam_dir)});
  return r;
}

// ---------------------------------------------------------------------
// scene tables in shared memory
// ---------------------------------------------------------------------

struct SceneView {
  const float* tri;   // [T, 12]
  const float* trin;  // [T, 10]
  const float* sph;   // [S, 5]
  const float* mat;   // [K, 17]
  int num_tris, num_spheres, num_materials;
  // The BVH tier's world BVH, its slot-order tables left in global memory
  // (`tri` and `trin` are unused there)
  BvhView bvh;
};

__host__ __device__ __forceinline__ size_t scene_smem_floats(
    int num_tris, int num_spheres, int num_materials) {
  return static_cast<size_t>(num_tris) * (kTriStride + kTrinStride) +
         static_cast<size_t>(num_spheres) * kSphStride +
         static_cast<size_t>(num_materials) * kMatStride;
}

// Copies the tables from global memory into `smem` (16-byte aligned, the
// triangle rows first) once per block (at most ~17 KB at the caps); every thread of a warp then reads the same
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
constexpr uint64_t kByteOnes = 0x0101010101010101ull;

// A medium is only ever the inside of a material: its IOR, absorption and
// priority are columns 12, 13:16 and 16 of the material's row, which the
// block holds in shared memory. So a medium is its material id, and the
// empty medium (IOR 1, no absorption, priority 2^31 - 1) is kNoMedium.
__device__ __forceinline__ float medium_ior(const float* mat, int id) {
  return id < 0 ? 1.0f : mat[id * kMatStride + 12];
}

__device__ __forceinline__ int medium_prio(const float* mat, int id) {
  return id < 0 ? kEmptyPrio : static_cast<int>(mat[id * kMatStride + 16]);
}

// One ray's stack, sorted by descending priority from slot 0 up; the top
// is slot size - 1. The Pallas `_Stack` keeps six fields a slot as
// per-slot lists and shifts them under masks; here a slot is one byte (a
// material id, < 64) of a 64-bit word, a push inserts a byte and a pop
// deletes one, which leaves the slots under `size` as `_Stack`'s shifts
// do. Slots at or above `size` are never read (so the wrapping shift of
// `_Stack`'s pop needs no copy).
struct MediumStack {
  uint64_t ids;  // slot k in byte k
  int size;

  __device__ __forceinline__ void init() {
    ids = 0ull;
    size = 0;
  }

  __device__ __forceinline__ int id_at(int k) const {
    return static_cast<int>((ids >> (8 * k)) & 0xFFull);
  }

  // get_top_ray_medium (compute:647-654)
  __device__ __forceinline__ int top() const {
    return size == 0 ? kNoMedium : id_at(size - 1);
  }

  // determine_true_medium_hit (compute:656-665)
  __device__ __forceinline__ bool is_true_hit(const float* mat, int p) const {
    return size == 0 || p <= medium_prio(mat, top());
  }

  // add_to_medium_stack (compute:582-622): at the top when prio <= the
  // top's (the empty stack's top is 2^31 - 1), else at the count of
  // strictly greater entries; a full stack drops the push.
  __device__ __forceinline__ void push(const float* mat, int id, int prio,
                                       bool mask) {
    if (!mask || size >= kStackDepth) return;
    int idx = size;
    if (prio > medium_prio(mat, top())) {
      idx = 0;
      for (int k = 0; k < size; ++k)
        idx += medium_prio(mat, id_at(k)) > prio ? 1 : 0;
    }
    const uint64_t low = (1ull << (8 * idx)) - 1ull;  // idx <= 7
    ids = (ids & low) | (static_cast<uint64_t>(id) << (8 * idx)) |
          ((ids & ~low) << 8);
    ++size;
  }

  // pop_from_medium_stack (compute:627-642): remove the lowest slot with
  // id `id`, shifting the ones above it down; a missing id is a no-op.
  __device__ __forceinline__ void pop_id(int id, bool mask) {
    // a flag in bit 7 of every byte equal to `id`: the zero-byte test's
    // false positives lie above a true one, so the lowest flag is exact
    const uint64_t x = ids ^ (kByteOnes * static_cast<uint64_t>(id));
    uint64_t flags = (x - kByteOnes) & ~x & (kByteOnes << 7);
    if (size < kStackDepth) flags &= (1ull << (8 * size)) - 1ull;
    if (!mask || flags == 0ull) return;
    const int first = (__ffsll(static_cast<long long>(flags)) - 1) >> 3;
    const uint64_t low = (1ull << (8 * first)) - 1ull;
    ids = (ids & low) | ((ids >> 8) & ~low);
    --size;
  }
};

// ---------------------------------------------------------------------
// one bounce of one path
// ---------------------------------------------------------------------

struct PathConfig {
  float far;
  int max_bounces, lim_d, lim_g, lim_t;
  bool sobol, use_rr;
  // env NEE: the draw table of an H x W map, a row of four float4s a
  // texel (kernels/megakernel.py `env_table`)
  const float4* env_tab = nullptr;
  int env_h = 0, env_w = 0;
};

constexpr uint32_t kDimEnvNeeBase = 1u << 16;  // sobol.DIM_ENV_NEE_BASE
constexpr uint32_t kDimLightNeeSel = 1u << 17;  // sobol.DIM_LIGHT_NEE_SEL
constexpr uint32_t kDimLightNeePoint = (1u << 17) + 1u;  // DIM_LIGHT_NEE_POINT
constexpr float kVisScale = 0.999f;  // float32(1 - 1e-3), trace.py:402

// Area-light NEE's tables (kernels/megakernel.py `light_table`): one row of
// four float4s a light, (cdf, sel, pdf_area, code) | (emission rgb
// premultiplied, p0.x) | (p0.yz, p1.xy) | (p1.z, p2.xyz), code the
// triangle's index in the tier's order (the BVH tier's slot) or -1 - the
// sphere's, p0-p2 the triangle's vertices or (center, radius) of the
// sphere; and `dens` [T + S]: each triangle's pdf_area in the tier's order,
// then each sphere's selection probability (0 for non-emitters).
struct LightView {
  const float4* rows = nullptr;
  const float* dens = nullptr;
  int count = 0, num_tris = 0;
};

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
// With env NEE also the draw that reached the sky unoccluded, if any
// (nee_texel >= 0): the drawn texel of the finest mip (the alias texel
// where the draw took the alias), its radiance, the balance weight over
// the draw's pdf (w_fac) and the diffuse and glossy factors of the BRDF
// (dterm, gterm), so that the contribution is
// a_prev * (albedo * dterm + specular * gterm) * radiance * w_fac.
// With area-light NEE also the balance weight of the emission at this hit
// (em_w, 1 where light NEE did not cover the previous scatter) and the
// light term, if its shadow ray reached the drawn light (l_mat >= 0): the
// light's material, f = w_l / pdf_sa and the BRDF's factors, so that the
// term is a_prev * (albedo * l_dterm + specular * l_gterm) * emission(l_mat)
// * l_f.
struct BounceRecord {
  V3 a_prev;
  int mat, ab_mat;
  float t_safe;
  bool spec, refr, is_true, absorbing, survive;
  int nee_texel;
  V3 nee_rad;
  float nee_wfac, nee_dterm, nee_gterm;
  float em_w;
  int l_mat;
  float l_f, l_dterm, l_gterm;
};

enum BounceResult {
  kEnded = 0,         // nothing shaded: over a bounce limit
  kShadedEnded = 1,   // shaded, then killed by Russian roulette
  kShadedGoesOn = 2,  // shaded, the path goes on
  kMissed = 3,        // nothing shaded: the ray left for the sky
};

// The packed word of a shaded bounce in the adjoint's transcript: the hit
// material in bits 0-7, the Beer material in 8-15 (0 where the bounce does
// not absorb), and the masks.
constexpr uint32_t kSpec = 1u << 16;
constexpr uint32_t kAbsorbing = 1u << 17;
constexpr uint32_t kSurvive = 1u << 18;
constexpr uint32_t kTrueHit = 1u << 19;
constexpr uint32_t kRefr = 1u << 20;

__device__ __forceinline__ uint32_t pack_bounce(const BounceRecord& r) {
  return static_cast<uint32_t>(r.mat) |
         (r.absorbing ? static_cast<uint32_t>(r.ab_mat) << 8 : 0u) |
         (r.spec ? kSpec : 0u) | (r.absorbing ? kAbsorbing : 0u) |
         (r.survive ? kSurvive : 0u) | (r.is_true ? kTrueHit : 0u) |
         (r.refr ? kRefr : 0u);
}

// With area-light NEE the word's free bits also hold the light term's
// material (bits 21-26: materials are capped at 64) and whether the term
// was added (kLit); both 0 where it was not.
constexpr int kLightMatShift = 21;
constexpr uint32_t kLightMatMask = 0x3fu;
constexpr uint32_t kLit = 1u << 27;

__device__ __forceinline__ uint32_t pack_light(const BounceRecord& r) {
  return r.l_mat >= 0 ? (static_cast<uint32_t>(r.l_mat) << kLightMatShift) |
                            kLit
                      : 0u;
}

// The transcript a forward kernel records for the sweep-only adjoint
// (adjoint.cu `adjoint_sweep`): per shaded bounce what the replay would
// rebuild, slot-major, so that the sweep's loads of one slot by
// consecutive rays are consecutive: slot k of ray i is element k * n + i.
// Slots at or past a ray's shaded count are never written nor read.
struct RecordView {
  float4* a = nullptr;       // a_prev rgb, t_safe
  uint32_t* word = nullptr;  // pack_bounce
  float4* nq = nullptr;      // env NEE: radiance * w_fac rgb, dterm
  float2* ngw = nullptr;     // env NEE: gterm, w_fac
  int* texel = nullptr;      // env NEE: the drawn texel, -1 none
  uint32_t* end = nullptr;   // [n]: shaded bounces | missed << 31
  int n = 0;
  float4* lq = nullptr;      // light NEE: l_f, l_dterm, l_gterm, em_w
};

constexpr uint32_t kEndMissed = 1u << 31;

// Bounce k of ray i into `rv`. The NEE words of a bounce whose draw did
// not reach the sky are zeros (the replay's transcript holds the same);
// with light NEE so are the light term's three factors where it was not
// added (em_w is written on every shaded bounce).
template <bool kEnvNee, bool kLightNee = false>
__device__ __forceinline__ void record_bounce(const RecordView& rv, int i,
                                              int k, const BounceRecord& r) {
  const size_t s = static_cast<size_t>(k) * rv.n + i;
  rv.a[s] = make_float4(r.a_prev.x, r.a_prev.y, r.a_prev.z, r.t_safe);
  if constexpr (kLightNee) {
    rv.word[s] = pack_bounce(r) | pack_light(r);
    const bool lit = r.l_mat >= 0;
    rv.lq[s] = make_float4(lit ? r.l_f : 0.0f, lit ? r.l_dterm : 0.0f,
                           lit ? r.l_gterm : 0.0f, r.em_w);
  } else {
    rv.word[s] = pack_bounce(r);
  }
  if constexpr (kEnvNee) {
    const bool lit = r.nee_texel >= 0;
    rv.nq[s] = lit ? make_float4(r.nee_rad.x * r.nee_wfac,
                                 r.nee_rad.y * r.nee_wfac,
                                 r.nee_rad.z * r.nee_wfac, r.nee_dterm)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    rv.ngw[s] = lit ? make_float2(r.nee_gterm, r.nee_wfac)
                    : make_float2(0.0f, 0.0f);
    rv.texel[s] = r.nee_texel;
  }
}

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

// What the light-NEE probes (megakernel.cu `megakernel_bvh_light_probe`
// and `megakernel_light_probe`, measurement variants of B1e+d and B1e,
// never on a render's path) count of one ray's light shadow rays, and
// which decision drives its path (`mode`). Each ray has two shadow tests:
// the closest-hit rule's (the tier's rule before its redesign: on the
// BVH tier a closest-hit walk under the bound, on the brute tier
// Möller-Trumbore on every triangle) and the kernel's own (the any-hit
// walk, `light_visible_any`; the culled scan, `shadow_tris<true>`).
//   kProbeClosest: both tests, counted; the closest-hit rule decides;
//   kProbeKernel: both tests, counted; the kernel's test decides (its
//     bits);
//   kProbeClosestOnly, kProbeKernelOnly: that test alone (for its time);
//   kProbeNone: no test, every draw visible (the draw's own time).
// Counters: shadow rays, those the deciding test blocks, each test's
// triangle tests (the kernel's any-hit walk's with the light's own
// triangle) and box tests (0 on the brute tier), the triangles the culled
// scan skipped (0 on the BVH tier), the rays whose two decisions differ,
// and of those the ones where the closest-hit walk met another triangle at
// exactly the light's t (a tie; the brute tier's two rules decide alike on
// every ray).
enum ProbeMode {
  kProbeClosest = 0,
  kProbeKernel = 1,
  kProbeClosestOnly = 2,
  kProbeKernelOnly = 3,
  kProbeNone = 4,
};
enum ProbeCount {
  kProbeRays = 0,
  kProbeBlocked,
  kProbeTriClosest,
  kProbeBoxClosest,
  kProbeTriKernel,
  kProbeBoxKernel,
  kProbeCulled,
  kProbeDiffer,
  kProbeTies,
  kProbeWords,
};

struct LightProbe {
  int mode = kProbeKernel;
  int count[kProbeWords] = {};
};

// The sphere rule of a light shadow ray that no triangle under its bound
// occludes: visible iff the sphere hit is the light itself or lies at or
// past `bound`.
__device__ __forceinline__ bool sphere_rule(bool is_tri, int idx, float sp_t,
                                            int sp_i, float bound) {
  return (!is_tri && sp_i == idx && sp_t < INFINITY) || sp_t >= bound;
}

// The BVH tier's light shadow ray by a closest-hit walk under `b` (B1e+d's
// rule before its any-hit walk, kept for the probe): a triangle found is
// the closest hit and lies before the bound.
template <bool kCount>
__device__ __forceinline__ bool light_visible_closest(
    const SceneView& sc, V3 o, V3 d, float b, bool is_tri, int idx,
    float sp_t, int sp_i, float bound, BvhHit& h) {
  h = {b, 0.0f, 0.0f, 0.0f, -1, 0, 0};
  if (bvh_walk<false, kCount>(sc.bvh, o, d, h)) return is_tri && h.slot == idx;
  return sphere_rule(is_tri, idx, sp_t, sp_i, bound);
}

// The same decision by an any-hit walk. A triangle light's own row is
// tested first, with the walk's `triangle_hit` on the walk's row, which
// gives its t_l; the walk under min(b, t_l) then stops at the first
// triangle, which lies in front of the light (or of the bound): occluded.
// Where none does and t_l < b, the light is the closest hit: visible.
// Else the sphere rule. A sphere light's walk runs under b. This is the
// closest-hit walk's answer but where another triangle lies at exactly
// t_l (the closest-hit walk takes the first it meets of two at one t).
template <bool kCount>
__device__ __forceinline__ bool light_visible_any(
    const SceneView& sc, V3 o, V3 d, float b, bool is_tri, int idx,
    float sp_t, int sp_i, float bound, BvhHit& h, float& t_l) {
  t_l = INFINITY;
  if (is_tri) {
    float t, u, v, det;
    if (triangle_hit(sc.bvh.tri + static_cast<size_t>(idx) * kTriRow4, o, d,
                     t, u, v, det))
      t_l = t;
  }
  h = {fminf(b, t_l), 0.0f, 0.0f, 0.0f, -1, is_tri ? 1 : 0, 0};
  if (bvh_walk<true, kCount>(sc.bvh, o, d, h)) return false;
  return t_l < b || sphere_rule(is_tri, idx, sp_t, sp_i, bound);
}

// The light shadow rule of the brute tier (trace.py:394-402) on the
// closest triangle hit (tr_t, tr_i) and sphere hit (sp_t, sp_i): the
// closest hit (the mesh-beats-sphere-by-HIT_EPS rule inside `far`) is the
// light itself (`is_tri`, `idx`), or lies at or past `bound`.
__device__ __forceinline__ bool closest_rule(float tr_t, int tr_i, float sp_t,
                                             int sp_i, float far, bool is_tri,
                                             int idx, float bound) {
  const bool mesh_wins = (tr_t < sp_t - kHitEps) && (tr_t < far);
  const bool self = is_tri ? (mesh_wins && tr_i == idx)
                           : (!mesh_wins && sp_t < INFINITY && sp_i == idx);
  return self || (mesh_wins ? tr_t : sp_t) >= bound;
}

// The cull's margin over u M1 S (see `shadow_tris`): 32 u = 2^-19.
constexpr float kCullMargin = 1.9073486328125e-6f;

// The closest triangle hit (tr_t, tr_i, first-min) of a brute-tier light
// shadow ray from `o` along `d`, over the triangles that can lie on its
// segment [o, o + d b], b = min(far, sphere t - HIT_EPS, kVisScale dist),
// with the Möller-Trumbore tests run and (kCull) the triangles culled.
//
// With kCull each triangle is first held against its plane: n = cross(e1,
// e2) (the row's last three floats), s0 = tvec . n and s1 = s0 + b (d . n)
// the two ends' signed distances times |n|. Where both exceed a margin m
// on one side, the segment cannot cross the plane, Möller-Trumbore is
// skipped, and the loop goes on to the next triangle: a warp whose lanes
// all cull it skips the test; the loop still takes every triangle, in
// order. Skipping is exact: a culled triangle's Möller-Trumbore t, had it
// run, is no hit or >= b. The closest hit over the other triangles then
// decides as the full scan's does (`closest_rule`): where the full scan's
// hit lies under b it is not culled, and both scans find it (the same t,
// the same first index); where it does not, it lies at or past the bound
// or behind the sphere hit (then past the bound too), and both decide by
// the spheres alone. So the light's own triangle, which lies at dist past
// the bound, may be culled as any other.
//
// The margin, for a float32 op rounding by at most u = 2^-24 (-fmad=false),
// tvec, d, e1, e2 the floats both tests read, N = tvec . n and D = d . n
// exactly, M1 = |e1|_1 |e2|_1 (>= |n_i|), S = |tvec|_1 + b |d|_1:
//   Möller-Trumbore's numerator e2 . (tvec x e1) is N within 5 u M1
//   |tvec|_1 (two roundings in each cross component, three in the dot),
//   its determinant e1 . (d x e2) is -D within 5 u M1 |d|_1, and 1 / det
//   and the product round twice more;
//   n, rounded once from the exact cross product, and the two dot products
//   give s0 within 4 u M1 |tvec|_1, and s1 within 6 u M1 S.
// Both ends beyond m = K u M1 S on the positive side (the negative side is
// the mirror) give N > (K - 4) u M1 S > 5 u M1 |tvec|_1, so the numerator
// is > 0, and N + b D > (K - 6) u M1 S >= 5 u M1 S + 2 u |N| (|N| <= M1
// |tvec|_1), so any t > 0 the test returns is >= (N - 5 u M1 |tvec|_1)(1
// - 2 u) / (-D + 5 u M1 |d|_1) >= b. That needs K >= 13 with the terms in
// u^2 neglected; K = 32 leaves room for them and for m's own rounding.
// No underflow matters: a hit needs |det| >= DET_EPS and t > HIT_EPS, so
// where b > HIT_EPS every term is far above float32's subnormals, and
// where b <= HIT_EPS no hit lies under b anyway. A NaN or an infinity
// fails both comparisons, and the test runs.
template <bool kCull>
__device__ __forceinline__ void shadow_tris(const SceneView& sc, V3 o, V3 d,
                                            float b, float& tr_t, int& tr_i,
                                            int& tests, int& culled) {
  tr_t = INFINITY;
  tr_i = -1;
  const float bd = b * (fabsf(d.x) + fabsf(d.y) + fabsf(d.z));
  for (int ti = 0; ti < sc.num_tris; ++ti) {
    const float4* row =
        reinterpret_cast<const float4*>(sc.tri + ti * kTriStride);
    const float4 r0 = row[0], r1 = row[1], r2 = row[2];
    const V3 v0 = {r0.x, r0.y, r0.z};
    const V3 e1 = {r0.w, r1.x, r1.y}, e2 = {r1.z, r1.w, r2.x};
    if constexpr (kCull) {
      // Möller-Trumbore's own tvec: the compiler computes it once
      const V3 tvec = {o.x - v0.x, o.y - v0.y, o.z - v0.z};
      const V3 n = {r2.y, r2.z, r2.w};
      const float s0 = dot3(tvec, n);
      const float s1 = s0 + b * dot3(d, n);
      const float m =
          kCullMargin *
          ((fabsf(e1.x) + fabsf(e1.y) + fabsf(e1.z)) *
           (fabsf(e2.x) + fabsf(e2.y) + fabsf(e2.z))) *
          (fabsf(tvec.x) + fabsf(tvec.y) + fabsf(tvec.z) + bd);
      if ((s0 > m && s1 > m) || (s0 < -m && s1 < -m)) {
        ++culled;
        continue;
      }
    }
    ++tests;
    float t, u, v, det;
    if (triangle_hit(v0, e1, e2, o, d, t, u, v, det) && t < tr_t) {
      tr_t = t;
      tr_i = ti;
    }
  }
}

// Whether the light NEE shadow ray from `o` along `d` reaches its light
// (trace.py:394-402): the closest hit (the mesh-beats-sphere-by-HIT_EPS
// rule inside `far`) is the light itself (`is_tri`, `idx`), or lies at or
// past kVisScale * dist. Both tiers decide under b = min(far, sphere t -
// HIT_EPS, kVisScale * dist). The brute tier takes the closest hit over
// the triangles its segment can cross (`shadow_tris<true>`), which
// decides as the closest hit over every triangle does. The BVH tier
// decides by the any-hit walk (`light_visible_any`), which stops at the
// first blocker; a closest-hit walk keeps descending the tree past it.
// It gives the brute answer up to exact ties in t. With kProbe
// (`LightProbe`) the probe's mode picks the tests and the decision, and
// its counters add up what they did.
template <bool kBvh, bool kProbe = false>
__device__ __forceinline__ bool light_visible(const SceneView& sc, V3 o,
                                              V3 d, float far, bool is_tri,
                                              int idx, float dist,
                                              LightProbe* pr = nullptr) {
  const V3 inv_d = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  float sp_t = INFINITY;
  int sp_i = -1;
  for (int si = 0; si < sc.num_spheres; ++si) {
    bool inside;
    const float t =
        sphere_t(sc.sph + si * kSphStride, o, d, inv_d, far, inside);
    if (t < sp_t) {
      sp_t = t;
      sp_i = si;
    }
  }
  const float bound = dist * kVisScale;
  if constexpr (kBvh) {
    const float b = fminf(fminf(far, sp_t - kHitEps), bound);
    BvhHit h;
    float t_l;
    if constexpr (kProbe) {
      const int mode = pr->mode;
      const bool closest = mode != kProbeKernelOnly && mode != kProbeNone;
      const bool any = mode != kProbeClosestOnly && mode != kProbeNone;
      BvhHit hc = {0.0f, 0.0f, 0.0f, 0.0f, -1, 0, 0};
      bool vc = true, va = true;
      t_l = INFINITY;
      h = hc;
      if (closest)
        vc = light_visible_closest<true>(sc, o, d, b, is_tri, idx, sp_t,
                                         sp_i, bound, hc);
      if (any)
        va = light_visible_any<true>(sc, o, d, b, is_tri, idx, sp_t, sp_i,
                                     bound, h, t_l);
      const bool vis = (mode == kProbeClosest || mode == kProbeClosestOnly)
                           ? vc
                           : va;
      int* c = pr->count;
      c[kProbeRays] += 1;
      c[kProbeBlocked] += vis ? 0 : 1;
      c[kProbeTriClosest] += hc.tri_tests;
      c[kProbeBoxClosest] += hc.box_tests;
      c[kProbeTriKernel] += h.tri_tests;
      c[kProbeBoxKernel] += h.box_tests;
      if (closest && any && vc != va) {
        c[kProbeDiffer] += 1;
        c[kProbeTies] += (is_tri && hc.slot >= 0 && hc.slot != idx &&
                          hc.t == t_l)
                             ? 1
                             : 0;
      }
      return vis;
    } else {
      return light_visible_any<false>(sc, o, d, b, is_tri, idx, sp_t, sp_i,
                                      bound, h, t_l);
    }
  } else {
    const float b = fminf(fminf(far, sp_t - kHitEps), bound);
    float tr_t;
    int tr_i, tests = 0, culled = 0;
    if constexpr (kProbe) {
      const int mode = pr->mode;
      const bool full = mode != kProbeKernelOnly && mode != kProbeNone;
      const bool cull = mode != kProbeClosestOnly && mode != kProbeNone;
      float tf;
      int fi, tests_f = 0, none = 0;
      bool vf = true, vc = true;
      if (full) {
        shadow_tris<false>(sc, o, d, b, tf, fi, tests_f, none);
        vf = closest_rule(tf, fi, sp_t, sp_i, far, is_tri, idx, bound);
      }
      if (cull) {
        shadow_tris<true>(sc, o, d, b, tr_t, tr_i, tests, culled);
        vc = closest_rule(tr_t, tr_i, sp_t, sp_i, far, is_tri, idx, bound);
      }
      const bool vis = (mode == kProbeClosest || mode == kProbeClosestOnly)
                           ? vf
                           : vc;
      int* c = pr->count;
      c[kProbeRays] += 1;
      c[kProbeBlocked] += vis ? 0 : 1;
      c[kProbeTriClosest] += tests_f;
      c[kProbeTriKernel] += tests;
      c[kProbeCulled] += culled;
      c[kProbeDiffer] += (full && cull && vf != vc) ? 1 : 0;
      return vis;
    } else {
      shadow_tris<true>(sc, o, d, b, tr_t, tr_i, tests, culled);
      return closest_rule(tr_t, tr_i, sp_t, sp_i, far, is_tri, idx, bound);
    }
  }
}

// Solid-angle pdf of cone-sampling a sphere light of selection probability
// `sel` from `p` (scene/lights.py `sphere_cone_pdf`; 0 inside the sphere).
__device__ __forceinline__ float sphere_cone_pdf(float sel, const float* sp,
                                                 V3 p) {
  const V3 dv = {sp[0] - p.x, sp[1] - p.y, sp[2] - p.z};
  const float d2 = dot3(dv, dv);
  const float sin2 = sp[3] * sp[3] / fmaxf(d2, 1e-12f);
  const float cos_max = sqrtf(fminf(fmaxf(1.0f - sin2, 0.0f), 1.0f));
  const float solid = kTwoPi * (1.0f - cos_max);
  return (sin2 < 1.0f && solid > 1e-12f) ? sel / fmaxf(solid, 1e-12f) : 0.0f;
}

// Balance-heuristic weight of the emission at a hit under light NEE
// (trace.py `emission_weight`): where light NEE covered the previous
// scatter (s.prev_nee), the continuation's pdf against the light table's
// solid-angle density of the emitter hit (a triangle's pdf_area t^2 /
// |cos|, a sphere's cone pdf from the previous origin `o`); else 1.
__device__ __forceinline__ float emission_weight(const SceneView& sc,
                                                 const LightView& lv,
                                                 const PathState& s, V3 o,
                                                 V3 d, V3 normal,
                                                 float t_safe, bool mesh_wins,
                                                 int tri, int sph) {
  if (!s.prev_nee) return 1.0f;
  float pdf;
  if (mesh_wins) {
    const float cos_hit = fabsf(dot3(d, normal));
    pdf = __ldg(lv.dens + tri) * t_safe * t_safe / fmaxf(cos_hit, 1e-6f);
  } else {
    pdf = sphere_cone_pdf(__ldg(lv.dens + lv.num_tris + sph),
                          sc.sph + sph * kSphStride, o);
  }
  return pdf > 0.0f ? s.prev_pcos / fmaxf(s.prev_pcos + pdf, 1e-12f) : 1.0f;
}

// The area-light NEE term of a bounce at an opaque hit (trace.py
// `light_nee`), added to s.color: the light by a binary search of the
// power CDF (the first row with cdf >= u, `searchsorted` 'left', clipped
// to the last), a point on a triangle by area or a direction in a
// sphere's cone, the shadow ray, the balance heuristic. `hit_tri` and
// `hit_sph` are the primitive shaded (-1 where none), which is never its
// own light. Where the term is added, its factors and the light's
// material go to `rec` for the adjoint (the caller sets rec.l_mat = -1;
// dead stores in a launch that records nothing).
template <bool kBvh, bool kProbe = false>
__device__ __forceinline__ void light_nee(const SceneView& sc,
                                          const LightView& lv,
                                          const PathConfig& cfg,
                                          uint32_t sidx, uint32_t seed,
                                          uint32_t stride, V3 pos, V3 normal,
                                          V3 refl, float r2, float ps,
                                          const float* m, int hit_tri,
                                          int hit_sph, PathState& s,
                                          BounceRecord& rec,
                                          LightProbe* pr = nullptr) {
  const float u_sel = sample_1d(cfg.sobol, sidx, kDimLightNeeSel + stride,
                                seed);
  float pu, pv;
  sample_2d(cfg.sobol, sidx, kDimLightNeePoint + stride, seed, &pu, &pv);
  int lo = 0, hi = lv.count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(&lv.rows[4 * static_cast<size_t>(mid)].x) < u_sel) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const float4* row = lv.rows + 4 * static_cast<size_t>(min(lo, lv.count - 1));
  const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2),
               e = __ldg(row + 3);
  const int code = static_cast<int>(a.w);
  const bool is_tri = code >= 0;
  const int idx = is_tri ? code : -1 - code;
  V3 wi;
  float dist, pdf_sa;
  bool ok;
  if (is_tri) {  // a uniform point on the triangle
    const V3 v0 = {b.w, c.x, c.y}, v1 = {c.z, c.w, e.x}, v2 = {e.y, e.z, e.w};
    const float su = sqrtf(fminf(fmaxf(pu, 0.0f), 1.0f));
    const float b0 = 1.0f - su, b1 = su * (1.0f - pv), b2 = su * pv;
    const V3 wv = {v0.x * b0 + v1.x * b1 + v2.x * b2 - pos.x,
                   v0.y * b0 + v1.y * b1 + v2.y * b2 - pos.y,
                   v0.z * b0 + v1.z * b1 + v2.z * b2 - pos.z};
    const V3 gn = cross3({v1.x - v0.x, v1.y - v0.y, v1.z - v0.z},
                         {v2.x - v0.x, v2.y - v0.y, v2.z - v0.z});
    const float d2 = dot3(wv, wv);
    dist = sqrtf(fmaxf(d2, 1e-12f));
    wi = {wv.x / dist, wv.y / dist, wv.z / dist};
    const float gl = fmaxf(sqrtf(dot3(gn, gn)), 1e-12f);
    const float cos_l = fabsf(dot3({gn.x / gl, gn.y / gl, gn.z / gl}, wi));
    pdf_sa = a.z * d2 / fmaxf(cos_l, 1e-6f);
    ok = cos_l > 1e-4f && a.z > 0.0f && idx != hit_tri;
  } else {  // a uniform direction in the sphere's cone
    const float rad = c.z;
    const V3 dv = {b.w - pos.x, c.x - pos.y, c.y - pos.z};
    const float dc2 = dot3(dv, dv);
    const float dc = sqrtf(fmaxf(dc2, 1e-12f));
    const V3 dh = {dv.x / dc, dv.y / dc, dv.z / dc};
    const float sin2max = rad * rad / fmaxf(dc2, 1e-12f);
    const float cos_max = sqrtf(fminf(fmaxf(1.0f - sin2max, 0.0f), 1.0f));
    const float cos_th = 1.0f - pu * (1.0f - cos_max);
    const float sin_th =
        sqrtf(fminf(fmaxf(1.0f - cos_th * cos_th, 0.0f), 1.0f));
    const float phi = pv * kTwoPi;
    const V3 up = fabsf(dh.y) < 0.9f ? V3{0.0f, 1.0f, 0.0f}
                                     : V3{1.0f, 0.0f, 0.0f};
    V3 tg = cross3(up, dh);
    const float tl = fmaxf(sqrtf(dot3(tg, tg)), 1e-12f);
    tg = {tg.x / tl, tg.y / tl, tg.z / tl};
    const V3 bt = cross3(dh, tg);
    const float sc_ = sin_th * cosf(phi), ss = sin_th * sinf(phi);
    wi = {dh.x * cos_th + tg.x * sc_ + bt.x * ss,
          dh.y * cos_th + tg.y * sc_ + bt.y * ss,
          dh.z * cos_th + tg.z * sc_ + bt.z * ss};
    const float solid = kTwoPi * (1.0f - cos_max);
    pdf_sa = a.y / fmaxf(solid, 1e-12f);
    dist = dc * cos_th -
           sqrtf(fmaxf(rad * rad - dc2 * sin_th * sin_th, 0.0f));
    ok = sin2max < 1.0f && solid > 1e-12f && idx != hit_sph;
  }
  const float cos_s = dot3(normal, wi);
  if (!ok || !(cos_s > 0.0f)) return;
  const V3 sh_o = {pos.x + normal.x * 1e-4f, pos.y + normal.y * 1e-4f,
                   pos.z + normal.z * 1e-4f};
  if (!light_visible<kBvh, kProbe>(sc, sh_o, wi, cfg.far, is_tri, idx, dist,
                                   pr))
    return;
  const float p_gl = glossy_pdf(wi, refl, r2, normal);
  const float p_mix = (1.0f - ps) * fmaxf(cos_s, 0.0f) * kInvPi + ps * p_gl;
  const float w_l = pdf_sa / fmaxf(pdf_sa + p_mix, 1e-12f);
  const float f = w_l / fmaxf(pdf_sa, 1e-12f);
  const float dterm = (1.0f - ps) * cos_s * kInvPi;
  const float gterm = ps * p_gl;
  s.color = {s.color.x + s.atten.x * (m[0] * dterm + m[4] * gterm) * b.x * f,
             s.color.y + s.atten.y * (m[1] * dterm + m[5] * gterm) * b.y * f,
             s.color.z + s.atten.z * (m[2] * dterm + m[6] * gterm) * b.z * f};
  // the light's material: column 9 of its triangle's normal row (the
  // tier's order, as `code`) or column 4 of its sphere's row
  rec.l_mat = static_cast<int>(
      is_tri ? sc.trin[static_cast<size_t>(idx) * kTrinStride + 9]
             : sc.sph[idx * kSphStride + 4]);
  rec.l_f = f;
  rec.l_dterm = dterm;
  rec.l_gterm = gterm;
}

// Advances `s` by bounce k of the path (trace_ray compute:876-950) and
// fills `rec` when the bounce shades. The caller stops at any result but
// kShadedGoesOn: every later update of the Pallas body is masked for a
// dead ray, so its state is frozen and leaving the loop is exact. With
// kLightNee (`lv` its tables) s.prev_nee is the flag of the JAX lockstep's
// prev_lnee too: both are the previous bounce's `covered`.
template <bool kTransmissive, bool kEnvNee, bool kBvh = false,
          bool kLightNee = false, bool kProbe = false>
__device__ __forceinline__ int path_bounce(const SceneView& sc,
                                           const PathConfig& cfg,
                                           uint32_t sidx, uint32_t seed,
                                           int k, PathState& s,
                                           BounceRecord& rec,
                                           const LightView& lv = LightView(),
                                           LightProbe* pr = nullptr) {
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
  int sp_i = -1, tr_i = -1;  // light NEE: the sphere and triangle hit
  for (int si = 0; si < sc.num_spheres; ++si) {
    const float* sp = sc.sph + si * kSphStride;
    bool inside;
    const float t = sphere_t(sp, o, d, inv_d, far, inside);
    if (t < sp_t) {
      sp_t = t;
      sp_orient = inside ? -1.0f : 1.0f;
      sp_c = {sp[0], sp[1], sp[2]};
      sp_mat = sp[4];
      if constexpr (kLightNee) sp_i = si;
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
      if constexpr (kLightNee) tr_i = h.slot;
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
        if constexpr (kLightNee) tr_i = ti;
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
  // the winner's normal alone normalized: the same bits as normalizing
  // both (elementwise), with one normalization's divisions
  const V3 normal = normalize3(
      sel3(mesh_wins, V3{tr_n.x * tr_s, tr_n.y * tr_s, tr_n.z * tr_s},
           V3{(pos.x - sp_c.x) * sp_orient, (pos.y - sp_c.y) * sp_orient,
              (pos.z - sp_c.z) * sp_orient}),
      1e-20f);
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
    return kMissed;
  }

  // --- emission before BRDF (compute:901-902); under light NEE weighted
  // by the balance heuristic where light NEE covered the previous scatter
  if constexpr (kLightNee) {
    const float w = emission_weight(sc, lv, s, o, d, normal, t_safe,
                                    mesh_wins, tr_i, sp_i);
    s.color = {s.color.x + em.x * s.atten.x * w,
               s.color.y + em.y * s.atten.y * w,
               s.color.z + em.z * s.atten.z * w};
    rec.em_w = w;  // for the adjoint (dead code in the forward kernel)
  } else {
    s.color = {s.color.x + em.x * s.atten.x, s.color.y + em.y * s.atten.y,
               s.color.z + em.z * s.atten.z};
  }

  // --- sampler draws for this bounce (dims = base + 5k, compute:921)
  const uint32_t stride = 5u * static_cast<uint32_t>(k);
  float r1u, r1v, p1u, p1v;
  sample_2d(cfg.sobol, sidx, 2u + stride, seed, &r1u, &r1v);
  sample_2d(cfg.sobol, sidx, 3u + stride, seed, &p1u, &p1v);
  const float rr = sample_1d(cfg.sobol, sidx, 4u + stride, seed);

  const bool entering = orient > 0.0f;
  float cur_ior, hit_ior;
  int cur_id = kNoMedium;  // the medium the ray travelled through
  bool true_hit = true;
  if constexpr (kTransmissive) {
    // interface tracking (evaluate_material_hit, compute:743-817); the
    // hit material's own medium has id mat_id
    const int prio = static_cast<int>(m[16]);
    const bool uses_tracking = prio >= 0;  // compute:758
    true_hit = !uses_tracking || s.stack.is_true_hit(sc.mat, prio);
    const int top0 = s.stack.top();
    const bool empty0 = s.stack.size == 0;
    s.stack.pop_id(mat_id, uses_tracking && !entering);
    const int top_ap = s.stack.top();
    cur_id = entering ? top0
                      : (uses_tracking ? (empty0 ? mat_id : top0) : mat_id);
    const int hit_id = entering ? mat_id : (uses_tracking ? top_ap : top0);
    s.stack.push(sc.mat, mat_id, prio, uses_tracking && entering);
    cur_ior = medium_ior(sc.mat, cur_id);
    hit_ior = medium_ior(sc.mat, hit_id);
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
    absorbing = cur_id != kNoMedium;
    ab_mat = cur_id;
    sc_at = mul3(sc_at,
                 beer_factor(mat_absorption(sc.mat + (absorbing ? cur_id : 0) *
                                                         kMatStride),
                             absorbing, t_safe));
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
    // alias step on one row of the draw table (envmap.sample_env_draw),
    // which also holds the direction of the texel and of its alias.
    float nu, nv;
    sample_2d(cfg.sobol, sidx, kDimEnvNeeBase + stride, seed, &nu, &nv);
    const int n_tex = cfg.env_h * cfg.env_w;
    const float rn = fminf(fmaxf(nu, 0.0f), 0.99999988f) *
                     static_cast<float>(n_tex);
    const int idx = min(max(static_cast<int>(rn), 0), n_tex - 1);
    // the row: (alias_p, alias_j, pdf, alias pdf), (radiance, dir.x),
    // (alias radiance, alias dir.x), (dir.yz, alias dir.yz)
    const float4* row = cfg.env_tab + 4 * static_cast<size_t>(idx);
    const float4 head = __ldg(row);
    const bool stay = nv < head.x;
    const float lpdf = stay ? head.z : head.w;
    const float4 rx = __ldg(row + (stay ? 1 : 2));
    const float4 yz = __ldg(row + 3);
    const V3 rad = {rx.x, rx.y, rx.z};
    const V3 ld = {rx.w, stay ? yz.x : yz.z, stay ? yz.y : yz.w};

    const float ps = spec_prob;
    const bool surf = m[3] >= 1.0f;
    const float cos_l = dot3(normal, ld);
    const bool cand = surf && cos_l > 0.0f && lpdf > 1e-12f;
    rec.nee_texel = -1;
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
        // for the adjoint (dead code in the forward kernel); alias_j is a
        // float32, exact below 2^24 texels
        rec.nee_texel = stay ? idx : static_cast<int>(head.y);
        rec.nee_rad = rad;
        rec.nee_wfac = w_fac;
        rec.nee_dterm = dterm;
        rec.nee_gterm = gterm;
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

  if constexpr (kLightNee) {
    // --- area-light next-event estimation + MIS (trace.py:332-432) on
    // opaque lobes, after env NEE's term where both are on
    const bool surf = m[3] >= 1.0f;
    if constexpr (!kEnvNee) {  // the continuation pdf, as env NEE keeps it
      const float cos_nd = dot3(normal, new_dir);
      const bool covered = surf && cos_nd > 0.0f && bounce_type != 2 &&
                           !(bounce_type == 1 && r2 <= 1e-6f);
      s.prev_pcos = covered ? (1.0f - spec_prob) * fmaxf(cos_nd, 0.0f) *
                                      kInvPi +
                                  spec_prob *
                                      glossy_pdf(new_dir, refl, r2, normal)
                            : 0.0f;
      s.prev_nee = covered;
    }
    rec.l_mat = -1;
    if (surf)
      light_nee<kBvh, kProbe>(sc, lv, cfg, sidx, seed, stride, pos, normal,
                              refl, r2, spec_prob, m, mesh_wins ? tr_i : -1,
                              mesh_wins ? -1 : sp_i, s, rec, pr);
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
    // divided, as the JAX lockstep divides (`atten / safe_c`, trace.py:456)
    const float c = fmaxf(contribution, 1e-20f);
    s.atten = {s.atten.x / c, s.atten.y / c, s.atten.z / c};
  }
  return kShadedGoesOn;
}

}  // namespace halogen
