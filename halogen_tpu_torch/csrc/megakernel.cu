// Fused-bounce path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces `halogen_tpu/kernels/megakernel.py::_make_kernel` (the Pallas
// TPU kernel) in its brute-force, opaque, no-NEE specialization
// (treelet_k=None, raylet_f=None, any_transmissive=False, env_nee=False):
// the whole path of one ray -- sampler draws, closest hit against every
// sphere and triangle, emission, the opaque BRDF, per-type bounce limits,
// Russian roulette and the deferred-miss record -- in one launch.
//
// What bounds it on this card: FP32 issue and warp divergence. Each
// ray-bounce runs about 14 primitive tests (12 triangles and 2 spheres of
// the Cornell box), one material lookup and ~600 integer ops of the
// Owen-scrambled Sobol sampler, while a ray moves only 72 bytes through
// device memory (32 in: origin, direction, sample index, seed; 40 out).
// The design keeps everything else on chip:
//   - one thread per ray, blocks of 128 threads, no padding of the ray
//     count (a bounds check masks the ragged edge);
//   - each block copies the scene tables (at most ~15 KB) from global to
//     shared memory once; every thread of a warp then reads the same
//     address, which the shared-memory crossbar broadcasts;
//   - the bounce loop runs inside the thread, and a dead ray leaves it
//     (`break`): every later update of the Pallas body is masked by
//     `active`/`shade`, so a dead ray's state is frozen and leaving is exact.
// The tables come in as pointers, not __constant__ symbols, so launches
// are re-entrant; the Sobol direction table is constant data and lives in
// __constant__ memory, read at a warp-uniform index.
//
// Float ops follow the Pallas body (`megakernel.py:1073-1554`) op for op:
// the same formulas, the same selection order, strict `<` for first-min
// ties, `>` for the bounce limits, RR's 1/p after the kill test and the
// roughness accumulator's `.x` quirk. Build with -fmad=false and without
// fast math so each op rounds as the plain PyTorch version's does.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

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

struct Params {
  const float* origin;     // [N, 3]
  const float* direction;  // [N, 3]
  const float* far;        // [1]
  const uint32_t* sample_idx;  // [N]
  const uint32_t* seed;        // [N]
  const float* tri;   // [T, 9]
  const float* trin;  // [T, 10]
  const float* sph;   // [S, 5]
  const float* mat;   // [K, 17]
  float* out;         // [N, 10]
  int n, num_tris, num_spheres, num_materials;
  int max_bounces, lim_d, lim_g, lim_t;
  bool sobol, use_rr;
};

__global__ void __launch_bounds__(kThreads) megakernel(Params p) {
  extern __shared__ float smem[];
  float* s_tri = smem;
  float* s_trin = s_tri + p.num_tris * kTriStride;
  float* s_sph = s_trin + p.num_tris * kTrinStride;
  float* s_mat = s_sph + p.num_spheres * kSphStride;
  for (int j = threadIdx.x; j < p.num_tris * kTriStride; j += blockDim.x)
    s_tri[j] = p.tri[j];
  for (int j = threadIdx.x; j < p.num_tris * kTrinStride; j += blockDim.x)
    s_trin[j] = p.trin[j];
  for (int j = threadIdx.x; j < p.num_spheres * kSphStride; j += blockDim.x)
    s_sph[j] = p.sph[j];
  for (int j = threadIdx.x; j < p.num_materials * kMatStride; j += blockDim.x)
    s_mat[j] = p.mat[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;

  const float far = p.far[0];
  V3 o = {p.origin[3 * i], p.origin[3 * i + 1], p.origin[3 * i + 2]};
  V3 d = {p.direction[3 * i], p.direction[3 * i + 1],
          p.direction[3 * i + 2]};
  const uint32_t sidx = p.sample_idx[i];
  const uint32_t seed = p.seed[i];

  V3 color = {0.0f, 0.0f, 0.0f};
  V3 atten = {1.0f, 1.0f, 1.0f};
  V3 matten = {0.0f, 0.0f, 0.0f};
  int n_diffuse = 0, n_glossy = 0;
  const int n_transmit = 0;  // opaque scenes never refract
  float acc_rough = 0.0f;
  bool active = true;

  for (int k = 0; k <= p.max_bounces; ++k) {
    // --- per-type termination (compute:869-871, `>` semantics)
    if (n_diffuse > p.lim_d || n_glossy > p.lim_g || n_transmit > p.lim_t)
      active = false;
    if (!active) break;

    const V3 inv_d = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};

    // --- spheres: linear scan, AABB pre-test vs far, first-min winner
    float sp_t = INFINITY, sp_orient = 1.0f;
    V3 sp_c = {0.0f, 0.0f, 0.0f};
    float sp_mat = 0.0f;
    for (int s = 0; s < p.num_spheres; ++s) {
      const float* sp = s_sph + s * kSphStride;
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
    for (int ti = 0; ti < p.num_tris; ++ti) {
      const float* tv = s_tri + ti * kTriStride;
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
        const float* tn = s_trin + ti * kTrinStride;
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
    const float* m = s_mat + static_cast<int>(mesh_wins ? tr_mat : sp_mat) *
                                 kMatStride;
    const V3 albedo = {m[0], m[1], m[2]};
    const V3 spec = {m[4], m[5], m[6]};
    const float metallic = m[7], roughness = m[8];
    const V3 em = {m[9], m[10], m[11]};
    const float ior = m[12];
    const V3 ab = {m[13], m[14], m[15]};

    // --- miss: record the deferred-sky attenuation, the ray dies
    if (!is_hit) {
      matten = atten;
      active = false;
      break;
    }

    // --- emission before BRDF (compute:901-902)
    color = {color.x + em.x * atten.x, color.y + em.y * atten.y,
             color.z + em.z * atten.z};

    // --- sampler draws for this bounce (dims = base + 5k, compute:921)
    const uint32_t stride = 5u * static_cast<uint32_t>(k);
    float r1u, r1v, p1u, p1v;
    sample_2d(p.sobol, sidx, 2u + stride, seed, &r1u, &r1v);
    sample_2d(p.sobol, sidx, 3u + stride, seed, &p1u, &p1v);
    const float rr = sample_1d(p.sobol, sidx, 4u + stride, seed);
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
    V3 sc_at = sel3(do_spec, spec, albedo);
    const V3 new_org = {pos.x + normal.x * kOffsetEps,
                        pos.y + normal.y * kOffsetEps,
                        pos.z + normal.z * kOffsetEps};
    // Beer-Lambert on exiting lanes (compute:810-813)
    if (!entering) {
      sc_at = {sc_at.x * expf(-ab.x * t_safe), sc_at.y * expf(-ab.y * t_safe),
               sc_at.z * expf(-ab.z * t_safe)};
    }

    o = new_org;
    d = new_dir;
    atten = {atten.x * sc_at.x, atten.y * sc_at.y, atten.z * sc_at.z};
    if (do_spec) {
      ++n_glossy;
    } else {
      ++n_diffuse;
    }
    // roughness accumulator quirk: scalar += roughness * atten.x
    acc_rough = acc_rough + roughness * atten.x;

    // --- Russian roulette (compute:923-936): 1/p after the kill test
    if (p.use_rr) {
      const float contribution = fmaxf(fmaxf(atten.x, atten.y), atten.z);
      if (rr > contribution) {
        active = false;
        break;
      }
      const float inv_c = 1.0f / fmaxf(contribution, 1e-20f);
      atten = {atten.x * inv_c, atten.y * inv_c, atten.z * inv_c};
    }
  }

  float* out = p.out + 10 * static_cast<size_t>(i);
  out[0] = color.x;
  out[1] = color.y;
  out[2] = color.z;
  out[3] = matten.x;
  out[4] = matten.y;
  out[5] = matten.z;
  out[6] = acc_rough;
  out[7] = d.x;
  out[8] = d.y;
  out[9] = d.z;
}

}  // namespace

extern "C" int halogen_megakernel_launch(
    const float* origin, const float* direction, const float* far,
    const int* sample_idx, const int* seed, const float* tri,
    const float* trin, const float* sph, const float* mat, float* out, int n,
    int num_tris, int num_spheres, int num_materials, int max_bounces,
    int lim_d, int lim_g, int lim_t, int sobol, int use_rr, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.origin = origin;
  p.direction = direction;
  p.far = far;
  p.sample_idx = reinterpret_cast<const uint32_t*>(sample_idx);
  p.seed = reinterpret_cast<const uint32_t*>(seed);
  p.tri = tri;
  p.trin = trin;
  p.sph = sph;
  p.mat = mat;
  p.out = out;
  p.n = n;
  p.num_tris = num_tris;
  p.num_spheres = num_spheres;
  p.num_materials = num_materials;
  p.max_bounces = max_bounces;
  p.lim_d = lim_d;
  p.lim_g = lim_g;
  p.lim_t = lim_t;
  p.sobol = sobol != 0;
  p.use_rr = use_rr != 0;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(num_tris) * (kTriStride + kTrinStride) +
                       static_cast<size_t>(num_spheres) * kSphStride +
                       static_cast<size_t>(num_materials) * kMatStride);
  const int blocks = (n + kThreads - 1) / kThreads;
  megakernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
