// Fused path-replay adjoint for NVIDIA Hopper (sm_90a): per-material
// cotangents of the traced path's outputs, the backward of megakernel.cu.
//
// Replaces `halogen_tpu/kernels/adjoint.py::_make_adjoint_kernel` (the
// Pallas TPU kernel) in its opaque branch (B2, any_transmissive=False)
// and its nested-dielectric branch (B2b, any_transmissive=True; Pallas
// :244-247, :273-297, :342-403, :499-521), and goes where the Pallas
// kernel does not: the JAX package differentiates big scenes and envmap
// scenes by the lockstep vjp (`megakernel.py:1953-1975`), which this
// kernel replaces on the card. Compile-time variants:
//   kTransmissive: B2 or B2b;
//   kBvh (B2+d, B2b+d): scenes over the brute tier's 128 triangles; the
//     replay's closest hit and shadow ray walk the world BVH
//     (bvh_traverse.cuh) in global memory, as B1d's do;
//   kEnv: 0 no sky; 1 the sky at the miss (B2c): the sky pass's backward
//     (sky.cu) hands each ray the cotangent of the miss attenuation and of
//     the accumulated roughness (the mip-bias level of the lookup), which
//     seed the sweep; 2 the same with env NEE (B2c+n): each bounce's NEE
//     term atten * f * L * w / pdf reaches the albedo and specular sums
//     and the attenuation's cotangent, and the replay writes one record
//     per (ray, bounce) -- the drawn texel and ct * atten * f * w / pdf --
//     which the sky backward sums into the finest mip.
// Three routes give the transcript of each shaded bounce to one reverse
// sweep (`sweep_bounce`, `warp_sums`), which all three run alike:
//   shared (`adjoint_kernel<*, true, *, *>`): the kernel replays the path
//     and keeps the transcript in the block's shared memory, where the
//     block fits `adjoint.SMEM_BUDGET`;
//   global (`<*, false, *, *>`): the same replay with the transcript in a
//     device buffer of the same layout, past that budget;
//   record (`adjoint_sweep<kTransmissive, kEnv, kLight>`): no replay.
//     The forward kernel recorded the transcript as it traced
//     (megakernel.cu `megakernel_record`, `megakernel_bvh_record`,
//     path_common.cuh `RecordView`). Both tiers take it where a step's
//     records fit `adjoint.RECORD_BUDGET` (`adjoint.record_plan`), else
//     they replay. With area-light NEE (kLight, B2+l; the JAX package
//     differentiates it by its lockstep vjp, `trace.py:200-229, 332-432`)
//     the record route is the only one: the forward's recording variants
//     (`megakernel_light_record`, `megakernel_bvh_light_record`) also
//     record each hit's emission weight and the light term's factors and
//     material, 16 bytes more a bounce, and the sweep adds the light's d
//     emission under a third key; past the budget such a step raises.
// All three give the same bits. On the replay routes, for every path it
//   1. replays the forward kernel's path through the same `path_bounce`
//      (path_common.cuh; with the same switches as the forward variant),
//      so the replay rounds as the forward does and takes its Fresnel,
//      refraction, Russian-roulette and NEE decisions bit for bit, and
//      records a transcript per shaded bounce (`adjoint.py:447-456`):
//      attenuation before the bounce, hit distance, and one word holding
//      the hit material, the material of the medium the ray came through
//      (whose absorption Beer-Lambert applied) and the mask bits (spec,
//      absorbing, survive, true hit, refraction); with env NEE also the
//      NEE's radiance times its weight and its two BRDF factors;
//   2. sweeps the bounces in reverse (`adjoint.py:480-583`): the
//      attenuation cotangent gA flows back through the RR division
//      1/max(atten) (the max's cotangent split evenly over argmax ties,
//      gated by the 1e-20 clamp) and the throughput product, and each
//      bounce routes d emission (premultiplied), d albedo or d specular
//      (by lobe; none on refraction and false hits, whose scatter color
//      is 1) to its hit material and d absorption to the current
//      medium's material; with the sky, gA starts at the miss
//      attenuation's cotangent where the path missed, and the roughness
//      accumulator's cotangent adds roughness to gA.x after each bounce
//      and atten.x to d roughness (a 13th column);
//   3. sums those per material in a fixed order, so two calls give the
//      same bits (see below); each block writes its partial [K, 12|13]
//      table, and a second kernel sums the blocks in a fixed tree.
// The record route runs steps 2 and 3 on the recorded words.
// A dead path stops its replay at its last shaded bounce; later bounces
// pass gA through unchanged and contribute nothing (`adjoint.py:551-561`),
// so sweeping only the shaded bounces is exact.
//
// What bounds the replay on this card: the replay, which is the forward
// kernel's bounce (FP32 and integer issue, divergence; B1b's bounce is
// ~three quarters of B2b's time; on the BVH tier the walk's dependent
// loads), then the sweep's ~60 flops a shaded bounce and the sums
// (PERF.md §6). What the design does about it:
//   - the transcript stays on chip: 20 bytes per bounce (a_prev rgb,
//     t, the packed word; 40 with env NEE) in shared memory, laid out
//     [bounce][field][thread] so that a warp's accesses fall in distinct
//     banks, sized from max_bounces at launch. Where it does not fit the
//     wrapper's shared-memory budget, the same layout goes to device
//     memory (the global route, [block][bounce][field][thread]); both give
//     the same bits. The BVH variants keep no triangles in shared memory;
//   - the sums run per warp, with no block barrier per bounce: each warp
//     sweeps its own paths at its own pace; per bounce the lanes of one
//     hit material (`__match_any_sync`), and for the absorption columns
//     those of one Beer material, add their values in a tree over their
//     ranks in lane order, and the group's lowest lane adds the sum to
//     the warp's [K, 12|13] table in shared memory (groups write distinct
//     rows, so there are no atomics); at the end the block adds its four
//     warp tables in warp order. Every order is fixed by lane and warp
//     position, so two calls give the same bits;
//   - one ray a thread, as B1d's glass variants: the replay needs no ray
//     counter, and a thread's transcript slot is its ray's;
//   - the NEE records go straight to device memory in ray-major order
//     ([N, B + 1]), where the sky backward's stable ordering by texel
//     keeps them in ray order; a float atomic per record would sum in
//     another order on every call.
// The replay traces again the paths the forward has just traced (on the
// BVH tier B2b+d takes 0.68-0.70 ms a 262144-ray launch of the glass
// dragon on an NVIDIA H100 80GB HBM3 at 700 W, of which the walk ~0.53;
// on the brute tier B2c+n re-runs every primitive test, draw and shadow
// ray of the `envmap_1024` paths; PERF.md §6). The record route trades
// that work for the
// transcript's bytes: 20 a shaded bounce (48 with env NEE) written by the
// forward and read once here, a dependent stream of ~60 flops a bounce,
// bound by memory latency. Its design: ray i on thread i % 128 of block
// i / 128 as on the replay routes, so the sums' orders and bits are the
// same; slot-major records, so a warp's loads of one slot are 512
// contiguous bytes (16-byte loads); only the material table in shared
// memory, and no minimum of blocks an SM (48 registers, 56 with env NEE).
// A register prefetch of bounce k - 1's words while bounce k is swept
// measured no faster on the glass dragon (0.0333-0.0339 against
// 0.0334-0.0337 ms a 262144-ray launch on the same H100; PERF.md §6), so
// each bounce's words are loaded as the sweep reaches them.
//
// Build with -fmad=false and without fast math, as megakernel.cu.

#include "path_common.cuh"

namespace {

using namespace halogen;

constexpr int kMaxMaterials = 64;   // kernels/megakernel.py MAX_MATERIALS
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// columns: d_e | d_albedo | d_specular | d_absorption, and with the sky
// d_roughness (through the mip-bias level of the sky lookup)
__host__ __device__ constexpr int n_grad(int env) { return env ? 13 : 12; }
// transcript words per bounce: A_prev rgb, t, the packed word; with env
// NEE its radiance * weight rgb, dterm, gterm
__host__ __device__ constexpr int n_rec(int env) { return env == 2 ? 10 : 5; }

struct Params {
  const float* origin;         // [N, 3]
  const float* direction;      // [N, 3]
  const float* far;            // [1]
  const uint32_t* sample_idx;  // [N]
  const uint32_t* seed;        // [N]
  const float* ct;             // [N, 3] cotangent of the path color
  const float* gsky;           // [N, 4] cotangent of the miss atten rgb and
                               // of the accumulated roughness (env >= 1)
  SceneView scene;             // global-memory tables
  uint32_t* transcript;        // global route: [blocks, B + 1, rec, 128]
  float* partial;              // [blocks, K * n_grad]
  float* color;                // [N, 3] replayed color, or null
  int* nee_key;                // [N, B + 1] drawn texel or -1 (env == 2)
  float* nee_w;                // [N, B + 1, 3] its cotangent (env == 2)
  int n;
  PathConfig cfg;
};

// Position of the n-th (from 0) set bit of `mask`, which has more than n.
__device__ __forceinline__ int nth_set_bit(unsigned mask, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(mask & ((1u << w) - 1u));
    if (n >= c) {
      n -= c;
      mask >>= w;
      pos += w;
    }
  }
  return pos;
}

// Adds, for every key that some lane of the warp holds (keys < 0 are
// skipped), columns [C0, C1) of g summed over the lanes holding it to row
// `key` of the warp's table `acc` (rows of NG columns). A group sums as a
// tree over its lanes' ranks in lane order (rank r takes rank r + s at
// step s), so the order depends on lane positions only; the group's
// lowest lane writes its row. Every lane of the warp calls this with the
// same C0, C1.
template <int C0, int C1, int NG>
__device__ __forceinline__ void warp_sum_by_key(int key, float (&g)[NG],
                                                float* acc) {
  const unsigned peers = __match_any_sync(kFull, key);
  const unsigned lane = threadIdx.x & 31u;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int size = key >= 0 ? __popc(peers) : 0;
  const int max_size = __reduce_max_sync(kFull, size);
  for (int s = 1; s < max_size; s <<= 1) {
    const bool take = (rank & (2 * s - 1)) == 0 && rank + s < size;
    const int src =
        take ? nth_set_bit(peers, rank + s) : static_cast<int>(lane);
#pragma unroll
    for (int c = C0; c < C1; ++c) {
      const float o = __shfl_sync(kFull, g[c], src);
      if (take) g[c] += o;
    }
  }
  if (rank == 0 && key >= 0) {
#pragma unroll
    for (int c = C0; c < C1; ++c) acc[key * NG + c] += g[c];
  }
  __syncwarp();  // the next bounce's writers of a row read this one's
}

// The transcript words of one shaded bounce, as the sweep reads them: on
// the replay routes word f of the bounce lies at w[f * kThreads] (shared or
// device memory, read where the sweep uses it); on the record route the
// forward kernel's `RecordView` rows, loaded ahead (RecordWords).
struct ReplayWords {
  const uint32_t* w;
  __device__ __forceinline__ V3 a_prev() const {
    return {__uint_as_float(w[0]), __uint_as_float(w[kThreads]),
            __uint_as_float(w[2 * kThreads])};
  }
  __device__ __forceinline__ float t_safe() const {
    return __uint_as_float(w[3 * kThreads]);
  }
  __device__ __forceinline__ uint32_t word() const { return w[4 * kThreads]; }
  __device__ __forceinline__ V3 nee_q() const {
    return {__uint_as_float(w[5 * kThreads]), __uint_as_float(w[6 * kThreads]),
            __uint_as_float(w[7 * kThreads])};
  }
  __device__ __forceinline__ float nee_dterm() const {
    return __uint_as_float(w[8 * kThreads]);
  }
  __device__ __forceinline__ float nee_gterm() const {
    return __uint_as_float(w[9 * kThreads]);
  }
};

struct RecordWords {
  float4 a = {0.0f, 0.0f, 0.0f, 0.0f};   // a_prev rgb, t_safe
  uint32_t w = 0u;                       // the packed word
  float4 nq = {0.0f, 0.0f, 0.0f, 0.0f};  // env NEE: q rgb, dterm
  float2 ngw = {0.0f, 0.0f};             // env NEE: gterm, w_fac
  int texel = -1;                        // env NEE: the drawn texel
  float4 lq = {0.0f, 0.0f, 0.0f, 1.0f};  // light NEE: f, dterm, gterm, em_w
  __device__ __forceinline__ V3 a_prev() const { return {a.x, a.y, a.z}; }
  __device__ __forceinline__ float t_safe() const { return a.w; }
  __device__ __forceinline__ uint32_t word() const { return w; }
  __device__ __forceinline__ V3 nee_q() const { return {nq.x, nq.y, nq.z}; }
  __device__ __forceinline__ float nee_dterm() const { return nq.w; }
  __device__ __forceinline__ float nee_gterm() const { return ngw.x; }
  __device__ __forceinline__ float4 light_q() const { return lq; }
};

// Slot k of ray i of the recorded transcript: 16- and 4-byte loads, those
// of consecutive rays consecutive (and with env NEE 16, 8 and 4 more; with
// light NEE 16 more).
template <bool kNee, bool kLight = false>
__device__ __forceinline__ RecordWords load_words(const RecordView& rv, int i,
                                                  int k) {
  const size_t s = static_cast<size_t>(k) * rv.n + i;
  RecordWords r;
  r.a = __ldg(rv.a + s);
  r.w = __ldg(rv.word + s);
  if constexpr (kNee) {
    r.nq = __ldg(rv.nq + s);
    r.ngw = __ldg(rv.ngw + s);
    r.texel = __ldg(rv.texel + s);
  }
  if constexpr (kLight) r.lq = __ldg(rv.lq + s);
  return r;
}

// The cotangent of an env-NEE draw's radiance, ct * a_prev * (albedo *
// dterm + specular * gterm) * w_fac, into out[0:3] (the record the sky
// backward sums into the drawn texel).
__device__ __forceinline__ void store_nee_weight(float* out, const float* m,
                                                 V3 ct, V3 a_prev,
                                                 float dterm, float gterm,
                                                 float wfac) {
  out[0] = ct.x * a_prev.x * (m[0] * dterm + m[4] * gterm) * wfac;
  out[1] = ct.y * a_prev.y * (m[1] * dterm + m[5] * gterm) * wfac;
  out[2] = ct.z * a_prev.z * (m[2] * dterm + m[6] * gterm) * wfac;
}

// One shaded bounce of the reverse sweep (`adjoint.py:480-583`), shared by
// both kernels so that they round alike: from the bounce's words `w`, the
// cotangent gA of the attenuation after the bounce and g_rough that of the
// accumulated roughness, its columns into g (zeros on entry), gA moved to
// before the bounce, and the keys of its sums: the hit material `mid` and
// the Beer material `abid` (-1: none). With kLight (area-light NEE, the
// record route only; B2+l) the emission is scaled by its balance weight
// em_w, and the light term a_prev * (albedo * dterm + specular * gterm) *
// emission(l) * f adds to gA, to the hit material's albedo and specular
// columns, and, as d emission of the light's material, to gl[0:3] with
// key `lid` (-1 where no term was added): a third key.
template <bool kTransmissive, int kEnv, bool kLight = false, typename Words>
__device__ __forceinline__ void sweep_bounce(const float* mat_tab,
                                             bool use_rr, V3 ct,
                                             const Words& w, V3& gA,
                                             float g_rough,
                                             float (&g)[n_grad(kEnv)],
                                             int& mid, int& abid,
                                             float* gl = nullptr,
                                             int* lid = nullptr) {
  constexpr bool kNee = kEnv == 2;
  const V3 a_prev = w.a_prev();
  const float t_safe = w.t_safe();
  const uint32_t word = w.word();
  const int mat = static_cast<int>(word & 0xffu);
  const int ab_mat = static_cast<int>((word >> 8) & 0xffu);
  const bool spec = (word & kSpec) != 0;
  const bool absorbing = (word & kAbsorbing) != 0;
  const bool survive = (word & kSurvive) != 0;
  // a refraction or a false hit scatters with color 1
  // (adjoint.py:512-516); opaque bounces never do
  const bool surf =
      !kTransmissive || ((word & kTrueHit) != 0 && (word & kRefr) == 0);

  // recompute the bounce's scatter factor (adjoint.py:499-524); the
  // absorption is the current medium's material row
  const float* m = mat_tab + mat * kMatStride;
  const V3 base = surf ? lobe_color(m, spec) : V3{1.0f, 1.0f, 1.0f};
  const V3 beer = beer_factor(
      mat_absorption(mat_tab + (absorbing ? ab_mat : mat) * kMatStride),
      absorbing, t_safe);
  const V3 scf = mul3(base, beer);
  const V3 a_post = mul3(a_prev, scf);

  // Russian roulette's 1/max(atten) (adjoint.py:526-547)
  V3 gp = gA;
  if (use_rr && survive) {
    const float contribution = fmaxf(fmaxf(a_post.x, a_post.y), a_post.z);
    const float inv_c = 1.0f / fmaxf(contribution, 1e-20f);
    const float tx = a_post.x == contribution ? 1.0f : 0.0f;
    const float ty = a_post.y == contribution ? 1.0f : 0.0f;
    const float tz = a_post.z == contribution ? 1.0f : 0.0f;
    const float n_tie = fmaxf(tx + ty + tz, 1.0f);
    // t / n_tie for t in {0, 1} and n_tie in {1, 2, 3} is 0 or 1 /
    // n_tie rounded, so a select gives the division's bits
    const float inv_tie =
        n_tie == 1.0f ? 1.0f : (n_tie == 2.0f ? 0.5f : 1.0f / 3.0f);
    const float gate = contribution > 1e-20f ? 1.0f : 0.0f;
    const float dot_ga = gA.x * a_post.x + gA.y * a_post.y + gA.z * a_post.z;
    gp = {gA.x * inv_c - tx * inv_tie * gate * dot_ga * inv_c * inv_c,
          gA.y * inv_c - ty * inv_tie * gate * dot_ga * inv_c * inv_c,
          gA.z * inv_c - tz * inv_tie * gate * dot_ga * inv_c * inv_c};
  }
  if constexpr (kEnv != 0) {
    // the roughness accumulator adds roughness * atten.x after the
    // scatter, before Russian roulette
    gp.x = gp.x + g_rough * m[8];
    g[12] = g_rough * a_post.x;
  }

  // throughput product and emission (adjoint.py:551-574)
  const V3 em = {m[9], m[10], m[11]};
  const V3 g_sc = mul3(gp, a_prev);
  const V3 g_base = mul3(g_sc, beer);
  const V3 g_beer = mul3(g_sc, base);
  if constexpr (kLight) {
    // the emission times its balance weight (trace.py:200-229)
    const float em_w = w.light_q().w;
    gA = {gp.x * scf.x + ct.x * em.x * em_w,
          gp.y * scf.y + ct.y * em.y * em_w,
          gp.z * scf.z + ct.z * em.z * em_w};
    g[0] = ct.x * a_prev.x * em_w;
    g[1] = ct.y * a_prev.y * em_w;
    g[2] = ct.z * a_prev.z * em_w;
  } else {
    gA = {gp.x * scf.x + ct.x * em.x, gp.y * scf.y + ct.y * em.y,
          gp.z * scf.z + ct.z * em.z};
    g[0] = ct.x * a_prev.x;
    g[1] = ct.y * a_prev.y;
    g[2] = ct.z * a_prev.z;
  }
  if (surf && spec) {
    g[6] = g_base.x;
    g[7] = g_base.y;
    g[8] = g_base.z;
  } else if (surf) {
    g[3] = g_base.x;
    g[4] = g_base.y;
    g[5] = g_base.z;
  }
  if (absorbing) {
    g[9] = -t_safe * beer.x * g_beer.x;
    g[10] = -t_safe * beer.y * g_beer.y;
    g[11] = -t_safe * beer.z * g_beer.z;
  }
  if constexpr (kNee) {
    // the NEE term a_prev * (albedo * dterm + specular * gterm) * q
    const V3 q = w.nee_q();
    const float dterm = w.nee_dterm();
    const float gterm = w.nee_gterm();
    const V3 cq = mul3(ct, q);
    gA = {gA.x + cq.x * (m[0] * dterm + m[4] * gterm),
          gA.y + cq.y * (m[1] * dterm + m[5] * gterm),
          gA.z + cq.z * (m[2] * dterm + m[6] * gterm)};
    const V3 ca = mul3(cq, a_prev);
    g[3] = g[3] + ca.x * dterm;
    g[4] = g[4] + ca.y * dterm;
    g[5] = g[5] + ca.z * dterm;
    g[6] = g[6] + ca.x * gterm;
    g[7] = g[7] + ca.y * gterm;
    g[8] = g[8] + ca.z * gterm;
  }
  if constexpr (kLight) {
    // the light term (trace.py:420-431), after env NEE's as in the forward
    const float4 lq = w.light_q();
    const bool lit = (word & kLit) != 0u;
    const int lmat = static_cast<int>((word >> kLightMatShift) &
                                      kLightMatMask);
    const float* lm = mat_tab + lmat * kMatStride;  // 0 where not lit
    const float f = lq.x, dterm = lq.y, gterm = lq.z;
    const V3 fr = {m[0] * dterm + m[4] * gterm, m[1] * dterm + m[5] * gterm,
                   m[2] * dterm + m[6] * gterm};
    const V3 cf = {ct.x * lm[9] * f, ct.y * lm[10] * f, ct.z * lm[11] * f};
    gA = {gA.x + cf.x * fr.x, gA.y + cf.y * fr.y, gA.z + cf.z * fr.z};
    const V3 ca = mul3(cf, a_prev);
    g[3] = g[3] + ca.x * dterm;
    g[4] = g[4] + ca.y * dterm;
    g[5] = g[5] + ca.z * dterm;
    g[6] = g[6] + ca.x * gterm;
    g[7] = g[7] + ca.y * gterm;
    g[8] = g[8] + ca.z * gterm;
    gl[0] = ct.x * a_prev.x * fr.x * f;
    gl[1] = ct.y * a_prev.y * fr.y * f;
    gl[2] = ct.z * a_prev.z * fr.z * f;
    *lid = lit ? lmat : -1;
  }
  mid = mat;
  abid = absorbing ? ab_mat : -1;
}

// A warp's sums of one bounce's columns: absorption follows the Beer
// material, the other columns the hit material; an opaque bounce's Beer
// material is its hit material (and its absorption columns are 0 where it
// does not absorb), so B2 sums all columns in one grouping.
template <bool kTransmissive, int kEnv>
__device__ __forceinline__ void warp_sums(int mid, int abid,
                                          float (&g)[n_grad(kEnv)],
                                          float* acc) {
  constexpr int kNG = n_grad(kEnv);
  if constexpr (kTransmissive) {
    warp_sum_by_key<0, 9>(mid, g, acc);
    if (__any_sync(kFull, abid >= 0)) warp_sum_by_key<9, 12>(abid, g, acc);
    if constexpr (kEnv != 0) warp_sum_by_key<12, 13>(mid, g, acc);
  } else {
    warp_sum_by_key<0, kNG>(mid, g, acc);
  }
}

template <bool kTransmissive, bool kSmemTranscript, bool kBvh, int kEnv>
__global__ void __launch_bounds__(kThreads) adjoint_kernel(Params p) {
  constexpr int kNG = n_grad(kEnv);
  constexpr int kRec = n_rec(kEnv);
  constexpr bool kNee = kEnv == 2;
  extern __shared__ float4 smem4[];  // 16-byte aligned triangle rows
  float* smem = reinterpret_cast<float*>(smem4);
  const SceneView sc = load_scene<kBvh>(p.scene, smem);
  const int n_acc = sc.num_materials * kNG;
  // [kWarps, K * kNG] sums, then (shared route) the transcript
  float* s_acc = smem + scene_smem_floats(kBvh ? 0 : p.scene.num_tris,
                                          p.scene.num_spheres,
                                          p.scene.num_materials);
  for (int j = threadIdx.x; j < kWarps * n_acc; j += kThreads)
    s_acc[j] = 0.0f;
  __syncthreads();

  const int tid = threadIdx.x;
  const int i = blockIdx.x * blockDim.x + tid;
  const bool valid = i < p.n;
  PathConfig cfg = p.cfg;
  cfg.far = p.far[0];
  const int slots = cfg.max_bounces + 1;
  // word f of bounce k of this thread's path: rec[(k * kRec + f) * kThreads]
  uint32_t* rec;
  if constexpr (kSmemTranscript) {
    rec = reinterpret_cast<uint32_t*>(s_acc + kWarps * n_acc) + tid;
  } else {
    rec = p.transcript +
          static_cast<size_t>(blockIdx.x) * slots * kRec * kThreads + tid;
  }
  const V3 ct = valid ? V3{p.ct[3 * i], p.ct[3 * i + 1], p.ct[3 * i + 2]}
                      : V3{0.0f, 0.0f, 0.0f};

  // ------------------------------------------------------------------
  // forward replay, recording the transcript of each shaded bounce
  // ------------------------------------------------------------------
  int n_shaded = 0;  // bounces 0 .. n_shaded-1 shaded
  bool missed = false;
  if (valid) {
    PathState s;
    s.o = {p.origin[3 * i], p.origin[3 * i + 1], p.origin[3 * i + 2]};
    s.d = {p.direction[3 * i], p.direction[3 * i + 1],
           p.direction[3 * i + 2]};
    const uint32_t sidx = p.sample_idx[i];
    const uint32_t seed = p.seed[i];
    if constexpr (kTransmissive) s.stack.init();
    BounceRecord r;
    int k = 0;
    for (; k <= cfg.max_bounces; ++k) {
      const int res = path_bounce<kTransmissive, kNee, kBvh>(sc, cfg, sidx,
                                                             seed, k, s, r);
      if (res == kEnded || res == kMissed) {
        missed = res == kMissed;
        break;
      }
      uint32_t* w = rec + k * kRec * kThreads;
      w[0] = __float_as_uint(r.a_prev.x);
      w[kThreads] = __float_as_uint(r.a_prev.y);
      w[2 * kThreads] = __float_as_uint(r.a_prev.z);
      w[3 * kThreads] = __float_as_uint(r.t_safe);
      w[4 * kThreads] = pack_bounce(r);
      if constexpr (kNee) {
        // the NEE term atten * f * L * w_fac: its radiance * weight and
        // BRDF factors for the sweep, and the texel's record
        const bool lit = r.nee_texel >= 0;
        const V3 q = lit ? V3{r.nee_rad.x * r.nee_wfac,
                              r.nee_rad.y * r.nee_wfac,
                              r.nee_rad.z * r.nee_wfac}
                         : V3{0.0f, 0.0f, 0.0f};
        w[5 * kThreads] = __float_as_uint(q.x);
        w[6 * kThreads] = __float_as_uint(q.y);
        w[7 * kThreads] = __float_as_uint(q.z);
        w[8 * kThreads] = __float_as_uint(lit ? r.nee_dterm : 0.0f);
        w[9 * kThreads] = __float_as_uint(lit ? r.nee_gterm : 0.0f);
        const size_t slot = static_cast<size_t>(i) * slots + k;
        p.nee_key[slot] = r.nee_texel;
        if (lit)
          store_nee_weight(p.nee_w + 3 * slot, sc.mat + r.mat * kMatStride,
                           ct, r.a_prev, r.nee_dterm, r.nee_gterm,
                           r.nee_wfac);
      }
      n_shaded = k + 1;
      if (res != kShadedGoesOn) {
        ++k;
        break;
      }
    }
    if constexpr (kNee) {
      for (; k <= cfg.max_bounces; ++k)
        p.nee_key[static_cast<size_t>(i) * slots + k] = -1;
    }
    if (p.color != nullptr) {
      p.color[3 * i] = s.color.x;
      p.color[3 * i + 1] = s.color.y;
      p.color[3 * i + 2] = s.color.z;
    }
  }

  // ------------------------------------------------------------------
  // reverse sweep and per-warp material sums, each warp at its own pace
  // ------------------------------------------------------------------
  float* acc = s_acc + (tid >> 5) * n_acc;
  V3 gA = {0.0f, 0.0f, 0.0f};
  float g_rough = 0.0f;  // cotangent of the accumulated roughness
  if constexpr (kEnv != 0) {
    if (valid) {
      // the sky at the miss multiplies the miss attenuation, the
      // attenuation after the last shaded bounce
      if (missed)
        gA = {p.gsky[4 * i], p.gsky[4 * i + 1], p.gsky[4 * i + 2]};
      g_rough = p.gsky[4 * i + 3];
    }
  }
  for (int k = __reduce_max_sync(kFull, n_shaded) - 1; k >= 0; --k) {
    float g[kNG];
#pragma unroll
    for (int j = 0; j < kNG; ++j) g[j] = 0.0f;
    int mid = -1, abid = -1;
    if (k < n_shaded)
      sweep_bounce<kTransmissive, kEnv>(
          sc.mat, cfg.use_rr, ct, ReplayWords{rec + k * kRec * kThreads},
          gA, g_rough, g, mid, abid);
    warp_sums<kTransmissive, kEnv>(mid, abid, g, acc);
  }

  // the block's partial table: its warps' tables added in warp order
  __syncthreads();
  for (int a = tid; a < n_acc; a += kThreads) {
    float sum = s_acc[a];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += s_acc[w * n_acc + a];
    p.partial[static_cast<size_t>(blockIdx.x) * n_acc + a] = sum;
  }
}

struct SweepParams {
  const float* mat;   // [K, 17]
  const float* ct;    // [N, 3] cotangent of the path color
  const float* gsky;  // [N, 4] (env >= 1), as Params
  RecordView rec;     // the forward kernel's transcript
  float* partial;     // [blocks, K * n_grad]
  int* nee_key;       // [N, B + 1] (env == 2), as Params
  float* nee_w;       // [N, B + 1, 3] (env == 2)
  int n, num_materials, slots;
  bool use_rr;
};

// The sweep of adjoint_kernel over the transcript its forward recorded
// (every variant, either tier, on the record route): no replay, so
// no triangles, BVH or rays; the material table in shared memory. Ray i
// is thread i % 128 of block i / 128, and the sweep, the warp sums and the
// block partials are adjoint_kernel's (`sweep_bounce`, `warp_sums`), so
// [K, 12|13] and the env-NEE records are the replay's bit for bit.
// kLight (B2+l, area-light NEE, which has no replay): the light term's
// words too; per bounce the d emission of the drawn lights is summed by
// light material after the hit and Beer materials' sums, in the same
// fixed order (lane ranks, then warps, then blocks), with no atomics.
template <bool kTransmissive, int kEnv, bool kLight>
__global__ void __launch_bounds__(kThreads) adjoint_sweep(SweepParams p) {
  constexpr int kNG = n_grad(kEnv);
  constexpr bool kNee = kEnv == 2;
  extern __shared__ float4 smem4[];
  float* mat = reinterpret_cast<float*>(smem4);
  const int n_mat = p.num_materials * kMatStride;
  const int n_acc = p.num_materials * kNG;
  float* s_acc = mat + n_mat;  // [kWarps, K * kNG] sums
  for (int j = threadIdx.x; j < n_mat; j += kThreads) mat[j] = p.mat[j];
  for (int j = threadIdx.x; j < kWarps * n_acc; j += kThreads)
    s_acc[j] = 0.0f;
  __syncthreads();

  const int tid = threadIdx.x;
  const int i = blockIdx.x * blockDim.x + tid;
  const bool valid = i < p.n;
  const V3 ct = valid ? V3{p.ct[3 * i], p.ct[3 * i + 1], p.ct[3 * i + 2]}
                      : V3{0.0f, 0.0f, 0.0f};
  const uint32_t end = valid ? p.rec.end[i] : 0u;
  const int n_shaded = static_cast<int>(end & 0xffffu);
  const bool missed = (end & kEndMissed) != 0u;
  if constexpr (kNee) {
    if (valid) {
      for (int k = n_shaded; k < p.slots; ++k)
        p.nee_key[static_cast<size_t>(i) * p.slots + k] = -1;
    }
  }

  float* acc = s_acc + (tid >> 5) * n_acc;
  V3 gA = {0.0f, 0.0f, 0.0f};
  float g_rough = 0.0f;
  if constexpr (kEnv != 0) {
    if (valid) {
      if (missed)
        gA = {p.gsky[4 * i], p.gsky[4 * i + 1], p.gsky[4 * i + 2]};
      g_rough = p.gsky[4 * i + 3];
    }
  }
  const int top = __reduce_max_sync(kFull, n_shaded) - 1;
  RecordWords cur;
  for (int k = top; k >= 0; --k) {
    if (k < n_shaded) cur = load_words<kNee, kLight>(p.rec, i, k);
    float g[kNG], gl[kNG];
#pragma unroll
    for (int j = 0; j < kNG; ++j) g[j] = gl[j] = 0.0f;
    int mid = -1, abid = -1, lid = -1;
    if (k < n_shaded) {
      sweep_bounce<kTransmissive, kEnv, kLight>(mat, p.use_rr, ct, cur, gA,
                                                g_rough, g, mid, abid, gl,
                                                &lid);
      if constexpr (kNee) {
        const size_t slot = static_cast<size_t>(i) * p.slots + k;
        p.nee_key[slot] = cur.texel;
        if (cur.texel >= 0)
          store_nee_weight(p.nee_w + 3 * slot, mat + mid * kMatStride, ct,
                           cur.a_prev(), cur.nee_dterm(), cur.nee_gterm(),
                           cur.ngw.y);
      }
    }
    warp_sums<kTransmissive, kEnv>(mid, abid, g, acc);
    if constexpr (kLight) {
      if (__any_sync(kFull, lid >= 0)) warp_sum_by_key<0, 3>(lid, gl, acc);
    }
  }

  // the block's partial table: its warps' tables added in warp order
  __syncthreads();
  for (int a = tid; a < n_acc; a += kThreads) {
    float sum = s_acc[a];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += s_acc[w * n_acc + a];
    p.partial[static_cast<size_t>(blockIdx.x) * n_acc + a] = sum;
  }
}

// out[a] = sum over blocks of partial[b, a], one block per entry a, in a
// fixed order: a strided sum per thread, then a tree in shared memory.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_blocks(const float* partial, int num_blocks, int n_acc,
                  float* out) {
  __shared__ float s[kReduceThreads];
  const int a = blockIdx.x;
  float sum = 0.0f;
  for (int b = threadIdx.x; b < num_blocks; b += kReduceThreads)
    sum += partial[static_cast<size_t>(b) * n_acc + a];
  s[threadIdx.x] = sum;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[a] = s[0];
}

// out[a] = the sum over groups of part[g, a], the last group first: the
// order in which autograd adds up the cotangents of one node a group (it
// runs the newest node first). Replaces no TPU kernel (autograd's sums a
// group did this); one thread an entry, [groups, K * 12|13] floats read
// once, a launch a chunk node's backward.
__global__ void __launch_bounds__(kReduceThreads)
    sum_groups(const float* part, int groups, int n_acc, float* out) {
  const int a = blockIdx.x * kReduceThreads + threadIdx.x;
  if (a >= n_acc) return;
  float sum = part[static_cast<size_t>(groups - 1) * n_acc + a];
  for (int g = groups - 2; g >= 0; --g)
    sum += part[static_cast<size_t>(g) * n_acc + a];
  out[a] = sum;
}

template <bool kTransmissive, bool kSmem, bool kBvh>
cudaError_t launch_env(int env, const Params& p, int blocks, size_t smem,
                       cudaStream_t st) {
  if (env == 2) {
    adjoint_kernel<kTransmissive, kSmem, kBvh, 2>
        <<<blocks, kThreads, smem, st>>>(p);
  } else if (env == 1) {
    adjoint_kernel<kTransmissive, kSmem, kBvh, 1>
        <<<blocks, kThreads, smem, st>>>(p);
  } else {
    adjoint_kernel<kTransmissive, kSmem, kBvh, 0>
        <<<blocks, kThreads, smem, st>>>(p);
  }
  return cudaGetLastError();
}

template <bool kTransmissive, bool kSmem>
cudaError_t launch_tier(bool bvh, int env, const Params& p, int blocks,
                        size_t smem, cudaStream_t st) {
  if (bvh) return launch_env<kTransmissive, kSmem, true>(env, p, blocks, smem,
                                                         st);
  return launch_env<kTransmissive, kSmem, false>(env, p, blocks, smem, st);
}

template <bool kTransmissive, int kEnv>
cudaError_t launch_sweep(const SweepParams& p, bool light, int blocks,
                         size_t smem, cudaStream_t st) {
  if (light) {
    adjoint_sweep<kTransmissive, kEnv, true>
        <<<blocks, kThreads, smem, st>>>(p);
  } else {
    adjoint_sweep<kTransmissive, kEnv, false>
        <<<blocks, kThreads, smem, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// `transcript` null: the shared route, the transcript in shared memory;
// else the global route, a [blocks, max_bounces + 1, rec, 128] word
// buffer. `nodes`: the world BVH's nodes on the BVH tier (`tri` and `trin`
// are then its slot-order tables). `env`: 0 no sky, 1 the sky at the miss
// (`gsky` [N, 4]), 2 the sky and env NEE (`env_tab` [H * W, 16], and the
// [N, B + 1] records `nee_key`, `nee_w`).
extern "C" int halogen_adjoint_launch(
    const float* origin, const float* direction, const float* far,
    const int* sample_idx, const int* seed, const float* ct,
    const float* tri, const float* trin, const float* sph, const float* mat,
    int* transcript, float* partial, float* out, float* color,
    const float* nodes, const float* gsky, const float* env_tab,
    int* nee_key, float* nee_w, int n, int num_tris, int num_spheres,
    int num_materials, int max_bounces, int lim_d, int lim_g, int lim_t,
    int sobol, int use_rr, int transmissive, int use_bvh, int env, int env_h,
    int env_w, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_materials > kMaxMaterials || max_bounces < 0 || env < 0 || env > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_acc = num_materials * n_grad(env);
  if (n <= 0)
    return static_cast<int>(
        cudaMemsetAsync(out, 0, sizeof(float) * n_acc, st));
  if ((use_bvh && nodes == nullptr) || (env >= 1 && gsky == nullptr) ||
      (env == 2 && (env_tab == nullptr || nee_key == nullptr ||
                    nee_w == nullptr || env_h <= 0 || env_w <= 0 ||
                    static_cast<long long>(env_h) * env_w > (1 << 24))))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.origin = origin;
  p.direction = direction;
  p.far = far;
  p.sample_idx = reinterpret_cast<const uint32_t*>(sample_idx);
  p.seed = reinterpret_cast<const uint32_t*>(seed);
  p.ct = ct;
  p.gsky = gsky;
  p.scene = {tri, trin, sph, mat, num_tris, num_spheres, num_materials,
             {reinterpret_cast<const float4*>(nodes),
              reinterpret_cast<const float4*>(tri), trin}};
  p.transcript = reinterpret_cast<uint32_t*>(transcript);
  p.partial = partial;
  p.color = color;
  p.nee_key = nee_key;
  p.nee_w = nee_w;
  p.n = n;
  p.cfg = {0.0f,        max_bounces, lim_d,  lim_g, lim_t, sobol != 0,
           use_rr != 0, reinterpret_cast<const float4*>(env_tab), env_h,
           env_w};
  const bool in_smem = transcript == nullptr;
  const bool bvh = use_bvh != 0;
  const size_t smem =
      sizeof(float) *
          (scene_smem_floats(bvh ? 0 : num_tris, num_spheres,
                             num_materials) +
           static_cast<size_t>(kWarps) * n_acc) +
      (in_smem ? sizeof(uint32_t) * (max_bounces + 1) * n_rec(env) * kThreads
               : 0);
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaError_t err;
  if (transmissive && in_smem) {
    err = launch_tier<true, true>(bvh, env, p, blocks, smem, st);
  } else if (transmissive) {
    err = launch_tier<true, false>(bvh, env, p, blocks, smem, st);
  } else if (in_smem) {
    err = launch_tier<false, true>(bvh, env, p, blocks, smem, st);
  } else {
    err = launch_tier<false, false>(bvh, env, p, blocks, smem, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_blocks<<<n_acc, kReduceThreads, 0, st>>>(partial, blocks, n_acc, out);
  return static_cast<int>(cudaGetLastError());
}

// The record route: the sweep over the transcript a forward launch of the
// megakernel recorded on these n rays (`rec_*`, path_common.cuh
// `RecordView`, for max_bounces + 1 slots), then the block sums. `env`,
// `gsky`, `nee_key` and `nee_w` as for halogen_adjoint_launch. `light`:
// area-light NEE (B2+l), whose record has `rec_lq` [B + 1, n] float4.
extern "C" int halogen_adjoint_sweep(
    const float* mat, const float* ct, const float* gsky, float* rec_a,
    int* rec_word, float* rec_nq, float* rec_ngw, int* rec_texel,
    int* rec_end, float* rec_lq, float* partial, float* out, int* nee_key,
    float* nee_w, int n, int num_materials, int max_bounces, int use_rr,
    int transmissive, int env, int light, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_materials > kMaxMaterials || max_bounces < 0 || env < 0 || env > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_acc = num_materials * n_grad(env);
  if (n <= 0)
    return static_cast<int>(
        cudaMemsetAsync(out, 0, sizeof(float) * n_acc, st));
  if (rec_a == nullptr || rec_word == nullptr || rec_end == nullptr ||
      (env >= 1 && gsky == nullptr) || (light && rec_lq == nullptr) ||
      (env == 2 && (rec_nq == nullptr || rec_ngw == nullptr ||
                    rec_texel == nullptr || nee_key == nullptr ||
                    nee_w == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  SweepParams p;
  p.mat = mat;
  p.ct = ct;
  p.gsky = gsky;
  p.rec = {reinterpret_cast<float4*>(rec_a),
           reinterpret_cast<uint32_t*>(rec_word),
           reinterpret_cast<float4*>(rec_nq),
           reinterpret_cast<float2*>(rec_ngw),
           rec_texel,
           reinterpret_cast<uint32_t*>(rec_end),
           n,
           reinterpret_cast<float4*>(rec_lq)};
  p.partial = partial;
  p.nee_key = nee_key;
  p.nee_w = nee_w;
  p.n = n;
  p.num_materials = num_materials;
  p.slots = max_bounces + 1;
  p.use_rr = use_rr != 0;
  const size_t smem = sizeof(float) * (static_cast<size_t>(num_materials) *
                                           kMatStride +
                                       static_cast<size_t>(kWarps) * n_acc);
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaError_t err;
  const bool lt = light != 0;
  if (transmissive) {
    err = env == 2   ? launch_sweep<true, 2>(p, lt, blocks, smem, st)
          : env == 1 ? launch_sweep<true, 1>(p, lt, blocks, smem, st)
                     : launch_sweep<true, 0>(p, lt, blocks, smem, st);
  } else {
    err = env == 2   ? launch_sweep<false, 2>(p, lt, blocks, smem, st)
          : env == 1 ? launch_sweep<false, 1>(p, lt, blocks, smem, st)
                     : launch_sweep<false, 0>(p, lt, blocks, smem, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_blocks<<<n_acc, kReduceThreads, 0, st>>>(partial, blocks, n_acc, out);
  return static_cast<int>(cudaGetLastError());
}

// The record route's backward of a chunk's `groups` launches (the chunk
// node, kernels/megakernel.py `_FusedChunk`): group g is
// halogen_adjoint_sweep over its slice of the record (buffers with a
// leading group axis, as halogen_megakernel_chunk writes them), with the
// same colour cotangent `ct` [n, 3] for every group, its block sums in
// `part` [groups, K * n_grad] (each group reuses `partial`, on the stream
// in turn), then `sum_groups` into `out` [K, n_grad]. `env` 0 (no sky) or
// 1 (the sky at the miss: `gsky` [groups, n, 4], each group's cotangents
// of the miss attenuation and the accumulated roughness, from the sky
// pass's backward of its outputs; 13 columns). Env NEE (2) takes one node
// a group: its records of the drawn texels are not kept here.
extern "C" int halogen_adjoint_sweep_chunk(
    const float* mat, const float* ct, const float* gsky, float* rec_a,
    int* rec_word, int* rec_end, float* rec_lq, float* partial, float* part,
    float* out, int n, int num_materials, int max_bounces, int use_rr,
    int transmissive, int env, int light, int groups, void* stream) {
  if (groups <= 0 || max_bounces < 0 || num_materials > kMaxMaterials ||
      env < 0 || env > 1 || (env == 1 && gsky == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t slot_rays = static_cast<size_t>(max_bounces + 1) * n;
  const int n_acc = num_materials * n_grad(env);
  for (int g = 0; g < groups; ++g) {
    int err = halogen_adjoint_sweep(
        mat, ct, env ? gsky + 4 * static_cast<size_t>(n) * g : nullptr,
        rec_a + 4 * slot_rays * g, rec_word + slot_rays * g, nullptr,
        nullptr, nullptr, rec_end + static_cast<size_t>(n) * g,
        light ? rec_lq + 4 * slot_rays * g : nullptr, partial,
        part + static_cast<size_t>(n_acc) * g, nullptr, nullptr, n,
        num_materials, max_bounces, use_rr, transmissive, env, light, stream);
    if (err != 0) return err;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sum_groups<<<(n_acc + kReduceThreads - 1) / kReduceThreads, kReduceThreads,
               0, st>>>(part, groups, n_acc, out);
  return static_cast<int>(cudaGetLastError());
}
