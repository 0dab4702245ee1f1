// Fused path-replay adjoint for NVIDIA Hopper (sm_90a): per-material
// cotangents of the traced color, the backward of megakernel.cu.
//
// Replaces `halogen_tpu/kernels/adjoint.py::_make_adjoint_kernel` (the
// Pallas TPU kernel) in its opaque branch (B2, any_transmissive=False)
// and its nested-dielectric branch (B2b, any_transmissive=True; Pallas
// :244-247, :273-297, :342-403, :499-521), two compile-time variants. For
// every path it
//   1. replays the forward kernel's path through the same `path_bounce`
//      (path_common.cuh; B2b through its medium-stack variant, B1b's), so
//      the replay rounds as the forward does and takes its Fresnel,
//      refraction and Russian-roulette decisions bit for bit, and
//      records a transcript per shaded bounce (`adjoint.py:447-456`):
//      attenuation before the bounce, hit material, mask code (shade,
//      spec, absorbing, survive, true hit, refraction), hit distance and
//      the material of the medium the ray came through (the current
//      medium, whose absorption Beer-Lambert applied; -1 elsewhere);
//   2. sweeps the bounces in reverse (`adjoint.py:480-583`): the
//      attenuation cotangent gA flows back through the RR division
//      1/max(atten) (the max's cotangent split evenly over argmax ties,
//      gated by the 1e-20 clamp) and the throughput product, and each
//      bounce routes d emission (premultiplied), d albedo or d specular
//      (by lobe; none on refraction and false hits, whose scatter color
//      is 1) to its hit material and d absorption to the current
//      medium's material;
//   3. sums those per material in a fixed order, so two calls give the
//      same bits: per bounce, the block's 128 threads put their 12 values
//      and material ids in shared memory and thread t sums accumulators
//      t, t + 128, ... of the [K, 12] table over the 128 entries in index
//      order; each block writes its partial table; a second kernel sums
//      the blocks in a fixed tree.
// A dead path stops its replay at its last shaded bounce; later bounces
// pass gA through unchanged and contribute nothing (`adjoint.py:551-561`),
// so sweeping only the shaded bounces is exact.
//
// What bounds it on this card: the replay, FP32 and integer throughput as in
// the forward kernel (the sweep adds ~60 flops per shaded bounce). On top
// of it come 28 bytes of transcript per shaded bounce, written in the
// replay and read back in the sweep by the same thread: lane i of a warp
// touches neighbouring addresses of a [B, 7, N] buffer, so both are
// coalesced, and at 262144 rays the buffer (~51 MB at 7 bounces) mostly
// stays in the 50 MB L2. The block reduction costs one barrier and
// 128 shared-memory reads per accumulator per bounce that any path of the
// block reached; rows are padded to 129 floats so that the threads of a
// warp, which read one column of different rows, hit different banks.
//
// B2b adds the stack's registers to the replay and a second material id
// per bounce to the sums (already there for B2's exiting hits); the
// transcript keeps its 7 rows, 66 MB at 8 bounces and 262144 rays.
//
// Build with -fmad=false and without fast math, as megakernel.cu.

#include "path_common.cuh"

namespace {

using namespace halogen;

constexpr int kRec = 7;             // transcript rows per bounce
constexpr int kNGrad = 12;          // d_e | d_albedo | d_specular | d_absorption
constexpr int kMaxMaterials = 64;   // kernels/megakernel.py MAX_MATERIALS
constexpr int kMaxAcc = kMaxMaterials * kNGrad / kThreads;  // per thread
constexpr int kPad = kThreads + 1;  // shared row stride
constexpr int kReduceThreads = 256;

struct Params {
  const float* origin;         // [N, 3]
  const float* direction;      // [N, 3]
  const float* far;            // [1]
  const uint32_t* sample_idx;  // [N]
  const uint32_t* seed;        // [N]
  const float* ct;             // [N, 3] cotangent of the color
  SceneView scene;             // global-memory tables
  float* transcript;           // [B, 7, N] scratch
  float* partial;              // [blocks, K * 12]
  float* color;                // [N, 3] replayed color, or null
  int n;
  PathConfig cfg;
};

template <bool kTransmissive>
__global__ void __launch_bounds__(kThreads) adjoint_kernel(Params p) {
  extern __shared__ float smem[];
  const SceneView sc = load_scene(p.scene, smem);
  float* s_g = smem + scene_smem_floats(p.scene.num_tris,
                                        p.scene.num_spheres,
                                        p.scene.num_materials);  // [12][kPad]
  int* s_id = reinterpret_cast<int*>(s_g + kNGrad * kPad);       // [2][kPad]
  __syncthreads();

  const int tid = threadIdx.x;
  const int i = blockIdx.x * blockDim.x + tid;
  const bool valid = i < p.n;
  const size_t n = static_cast<size_t>(p.n);
  PathConfig cfg = p.cfg;
  cfg.far = p.far[0];

  // ------------------------------------------------------------------
  // forward replay, recording the transcript of each shaded bounce
  // ------------------------------------------------------------------
  int n_shaded = 0;  // bounces 0 .. n_shaded-1 shaded
  if (valid) {
    PathState s;
    s.o = {p.origin[3 * i], p.origin[3 * i + 1], p.origin[3 * i + 2]};
    s.d = {p.direction[3 * i], p.direction[3 * i + 1],
           p.direction[3 * i + 2]};
    const uint32_t sidx = p.sample_idx[i];
    const uint32_t seed = p.seed[i];
    if constexpr (kTransmissive) s.stack.init();
    BounceRecord rec;
    for (int k = 0; k <= cfg.max_bounces; ++k) {
      const int r = path_bounce<kTransmissive, false>(sc, cfg, sidx, seed, k,
                                                      s, rec);
      if (r == kEnded) break;
      float* row = p.transcript + static_cast<size_t>(k) * kRec * n + i;
      const float code = 1.0f + (rec.spec ? 2.0f : 0.0f) +
                         (rec.absorbing ? 4.0f : 0.0f) +
                         (rec.survive ? 8.0f : 0.0f) +
                         (rec.is_true ? 16.0f : 0.0f) +
                         (rec.refr ? 32.0f : 0.0f);
      row[0] = rec.a_prev.x;
      row[n] = rec.a_prev.y;
      row[2 * n] = rec.a_prev.z;
      row[3 * n] = static_cast<float>(rec.mat);
      row[4 * n] = code;
      row[5 * n] = rec.t_safe;
      row[6 * n] = rec.absorbing ? static_cast<float>(rec.ab_mat) : -1.0f;
      n_shaded = k + 1;
      if (r != kShadedGoesOn) break;
    }
    if (p.color != nullptr) {
      p.color[3 * i] = s.color.x;
      p.color[3 * i + 1] = s.color.y;
      p.color[3 * i + 2] = s.color.z;
    }
  }

  // ------------------------------------------------------------------
  // reverse sweep and per-block material sums
  // ------------------------------------------------------------------
  const V3 ct = valid ? V3{p.ct[3 * i], p.ct[3 * i + 1], p.ct[3 * i + 2]}
                      : V3{0.0f, 0.0f, 0.0f};
  const int n_acc = sc.num_materials * kNGrad;
  V3 gA = {0.0f, 0.0f, 0.0f};
  float acc[kMaxAcc];
#pragma unroll
  for (int q = 0; q < kMaxAcc; ++q) acc[q] = 0.0f;

  for (int k = cfg.max_bounces; k >= 0; --k) {
    // A barrier, and a block-uniform skip of bounces no path reached.
    if (!__syncthreads_or(k < n_shaded)) continue;
    float g[kNGrad];
#pragma unroll
    for (int j = 0; j < kNGrad; ++j) g[j] = 0.0f;
    int mid = -1, abid = -1;
    if (k < n_shaded) {
      const float* row = p.transcript + static_cast<size_t>(k) * kRec * n + i;
      const V3 a_prev = {row[0], row[n], row[2 * n]};
      const int mat = static_cast<int>(row[3 * n]);
      const int code = static_cast<int>(row[4 * n]);
      const float t_safe = row[5 * n];
      const int ab_mat = static_cast<int>(row[6 * n]);
      const bool spec = (code & 2) != 0;
      const bool absorbing = (code & 4) != 0;
      const bool survive = (code & 8) != 0;
      // a refraction or a false hit scatters with color 1
      // (adjoint.py:512-516); opaque bounces never do
      const bool surf =
          !kTransmissive || ((code & 16) != 0 && (code & 32) == 0);

      // recompute the bounce's scatter factor (adjoint.py:499-524); the
      // absorption is the current medium's material row
      const float* m = sc.mat + mat * kMatStride;
      const V3 base = surf ? lobe_color(m, spec) : V3{1.0f, 1.0f, 1.0f};
      const V3 beer = beer_factor(
          mat_absorption(sc.mat + (absorbing ? ab_mat : mat) * kMatStride),
          absorbing, t_safe);
      const V3 scf = mul3(base, beer);
      const V3 a_post = mul3(a_prev, scf);

      // Russian roulette's 1/max(atten) (adjoint.py:526-547)
      V3 gp = gA;
      if (cfg.use_rr && survive) {
        const float contribution =
            fmaxf(fmaxf(a_post.x, a_post.y), a_post.z);
        const float inv_c = 1.0f / fmaxf(contribution, 1e-20f);
        const float tx = a_post.x == contribution ? 1.0f : 0.0f;
        const float ty = a_post.y == contribution ? 1.0f : 0.0f;
        const float tz = a_post.z == contribution ? 1.0f : 0.0f;
        const float n_tie = fmaxf(tx + ty + tz, 1.0f);
        const float gate = contribution > 1e-20f ? 1.0f : 0.0f;
        const float dot_ga =
            gA.x * a_post.x + gA.y * a_post.y + gA.z * a_post.z;
        gp = {gA.x * inv_c - tx / n_tie * gate * dot_ga * inv_c * inv_c,
              gA.y * inv_c - ty / n_tie * gate * dot_ga * inv_c * inv_c,
              gA.z * inv_c - tz / n_tie * gate * dot_ga * inv_c * inv_c};
      }

      // throughput product and emission (adjoint.py:551-574)
      const V3 em = {m[9], m[10], m[11]};
      const V3 g_sc = mul3(gp, a_prev);
      gA = {gp.x * scf.x + ct.x * em.x, gp.y * scf.y + ct.y * em.y,
            gp.z * scf.z + ct.z * em.z};
      const V3 g_base = mul3(g_sc, beer);
      const V3 g_beer = mul3(g_sc, base);
      g[0] = ct.x * a_prev.x;
      g[1] = ct.y * a_prev.y;
      g[2] = ct.z * a_prev.z;
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
      mid = mat;
      abid = absorbing ? ab_mat : -1;
    }

#pragma unroll
    for (int j = 0; j < kNGrad; ++j) s_g[j * kPad + tid] = g[j];
    s_id[tid] = mid;
    s_id[kPad + tid] = abid;
    __syncthreads();
    // accumulator a = material * 12 + column; absorption follows the
    // Beer material, the other columns the hit material
#pragma unroll
    for (int q = 0; q < kMaxAcc; ++q) {
      const int a = tid + q * kThreads;
      if (a < n_acc) {
        const int mat = a / kNGrad, c = a % kNGrad;
        const int* ids = s_id + (c < 9 ? 0 : kPad);
        const float* gc = s_g + c * kPad;
        float sum = acc[q];
        for (int e = 0; e < kThreads; ++e) sum += ids[e] == mat ? gc[e] : 0.0f;
        acc[q] = sum;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kMaxAcc; ++q) {
    const int a = tid + q * kThreads;
    if (a < n_acc)
      p.partial[static_cast<size_t>(blockIdx.x) * n_acc + a] = acc[q];
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

}  // namespace

extern "C" int halogen_adjoint_launch(
    const float* origin, const float* direction, const float* far,
    const int* sample_idx, const int* seed, const float* ct,
    const float* tri, const float* trin, const float* sph, const float* mat,
    float* transcript, float* partial, float* out, float* color, int n,
    int num_tris, int num_spheres, int num_materials, int max_bounces,
    int lim_d, int lim_g, int lim_t, int sobol, int use_rr, int transmissive,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_acc = num_materials * kNGrad;
  if (num_materials > kMaxMaterials)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0)
    return static_cast<int>(
        cudaMemsetAsync(out, 0, sizeof(float) * n_acc, st));
  Params p;
  p.origin = origin;
  p.direction = direction;
  p.far = far;
  p.sample_idx = reinterpret_cast<const uint32_t*>(sample_idx);
  p.seed = reinterpret_cast<const uint32_t*>(seed);
  p.ct = ct;
  p.scene = {tri, trin, sph, mat, num_tris, num_spheres, num_materials};
  p.transcript = transcript;
  p.partial = partial;
  p.color = color;
  p.n = n;
  p.cfg = {0.0f, max_bounces, lim_d, lim_g, lim_t, sobol != 0, use_rr != 0};
  const size_t smem =
      sizeof(float) * (scene_smem_floats(num_tris, num_spheres, num_materials) +
                       (kNGrad + 2) * kPad);
  const int blocks = (n + kThreads - 1) / kThreads;
  if (transmissive) {
    adjoint_kernel<true><<<blocks, kThreads, smem, st>>>(p);
  } else {
    adjoint_kernel<false><<<blocks, kThreads, smem, st>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_blocks<<<n_acc, kReduceThreads, 0, st>>>(partial, blocks, n_acc, out);
  return static_cast<int>(cudaGetLastError());
}
