// Fused-bounce path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces `halogen_tpu/kernels/megakernel.py::_make_kernel` (the Pallas
// TPU kernel) in its brute-force tier (treelet_k=None, raylet_f=None):
// the whole path of one ray -- sampler draws, closest hit against every
// sphere and triangle, emission, the BRDF, per-type bounce limits,
// Russian roulette and the deferred-miss record -- in one launch. The
// bounce body is `path_bounce` in path_common.cuh, shared with the
// adjoint kernel (adjoint.cu), which replays this path. Four
// compile-time variants, chosen by the entry point as the Pallas kernel
// is specialized statically:
//   B1a opaque, no NEE (any_transmissive=False, env_nee=False);
//   B1b nested dielectrics: a per-thread medium stack of 8 slots
//       (any_transmissive=True);
//   B1c env NEE: an envmap draw and a shadow ray per bounce, 12 outputs
//       (env_nee=True), alone or with B1b;
//   B1d the BVH tier (scenes over the brute tier's 128 triangles): each of
//       the above with the closest hit and the shadow ray walking the
//       world BVH (bvh_traverse.cuh) in global memory, in place of the
//       Pallas kernel's raylet tier (`_make_raylet_traversal`, :523); a
//       kernel of its own, `megakernel_bvh`, for its launch bounds.
// The sky itself is shaded after the kernel, once per ray, from the miss
// record (`kernels/megakernel.py`), as the Pallas wrapper does.
//
// What bounds it on this card: FP32 issue and warp divergence. Each
// ray-bounce runs about 14 primitive tests (12 triangles and 2 spheres of
// the Cornell box), one material lookup and ~600 integer ops of the
// Owen-scrambled Sobol sampler, while a ray moves only 72 bytes through
// device memory (32 in: origin, direction, sample index, seed; 40 out,
// 48 with env NEE). B1b adds the stack's unrolled selects (8 slots x 6
// values) and the registers to hold them; glass paths run longer (8
// bounces) and diverge more, since a warp's rays refract, reflect and
// pass through false hits on different bounces. B1c adds a second Sobol
// draw, one 40-byte row read from the [H*W, 10] draw table (cached in L1
// and L2), the sin/cos of the draw and a shadow ray per bounce, i.e.
// roughly twice the primitive tests. The TPU kernel took its env draws
// precomputed as a [7, K, N] table, because gathers are costly there;
// here the draw runs in the kernel, which saves the host the K Sobol
// evaluations per group and the ~37 MB buffer.
// B1d is bound by the walk instead: a dependent node or leaf load per step
// (latency; the ~1 MB of nodes and triangles of an 8.7k-triangle scene
// stay in L2) and the divergence of a warp's rays through the tree,
// which grows after the first bounce as glass rays refract and reflect
// (bvh_traverse.cuh says what the walk does about it). Its variants ask
// for kBvhMinBlocks = 4 blocks per SM (`__launch_bounds__`): the glass
// variant with env NEE then fits 128 registers (28 bytes of spill) and
// runs faster than at the 135 it takes unbounded; 5 or more blocks spill
// hundreds of bytes and run slower (PERF.md §6).
// The design keeps everything else on chip:
//   - one thread per ray, blocks of 128 threads, no padding of the ray
//     count (a bounds check masks the ragged edge);
//   - each block copies the scene tables into shared memory once;
//   - the bounce loop runs inside the thread, and a dead ray leaves it.
// The tables come in as pointers, not __constant__ symbols, so launches
// are re-entrant; the Sobol direction table is constant data and lives in
// __constant__ memory, read at a warp-uniform index.
//
// Build with -fmad=false and without fast math so each op rounds as the
// plain PyTorch version's does.

#include "path_common.cuh"

namespace {

using namespace halogen;

// blocks of 128 threads per SM that the BVH tier's variants must fit
constexpr int kBvhMinBlocks = 4;

struct Params {
  const float* origin;         // [N, 3]
  const float* direction;      // [N, 3]
  const float* far;            // [1]
  const uint32_t* sample_idx;  // [N]
  const uint32_t* seed;        // [N]
  SceneView scene;             // global-memory tables
  float* out;                  // [N, 10], or [N, 12] with env NEE
  int n;
  PathConfig cfg;
};

// The path of ray blockIdx.x * blockDim.x + threadIdx.x, into p.out.
template <bool kTransmissive, bool kEnvNee, bool kBvh>
__device__ __forceinline__ void trace_path(const Params& p) {
  extern __shared__ float smem[];
  const SceneView sc = load_scene<kBvh>(p.scene, smem);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;

  PathConfig cfg = p.cfg;
  cfg.far = p.far[0];
  PathState s;
  s.o = {p.origin[3 * i], p.origin[3 * i + 1], p.origin[3 * i + 2]};
  s.d = {p.direction[3 * i], p.direction[3 * i + 1], p.direction[3 * i + 2]};
  const uint32_t sidx = p.sample_idx[i];
  const uint32_t seed = p.seed[i];
  if constexpr (kTransmissive) s.stack.init();

  BounceRecord rec;
  for (int k = 0; k <= cfg.max_bounces; ++k) {
    if (path_bounce<kTransmissive, kEnvNee, kBvh>(sc, cfg, sidx, seed, k, s,
                                                  rec) != kShadedGoesOn)
      break;
  }

  constexpr int kOut = kEnvNee ? 12 : 10;
  float* out = p.out + kOut * static_cast<size_t>(i);
  out[0] = s.color.x;
  out[1] = s.color.y;
  out[2] = s.color.z;
  out[3] = s.matten.x;
  out[4] = s.matten.y;
  out[5] = s.matten.z;
  out[6] = s.acc_rough;
  out[7] = s.d.x;
  out[8] = s.d.y;
  out[9] = s.d.z;
  if constexpr (kEnvNee) {
    out[10] = s.m_pcos;
    out[11] = s.m_nee ? 1.0f : 0.0f;
  }
}

// The brute tier (B1a-c).
template <bool kTransmissive, bool kEnvNee>
__global__ void __launch_bounds__(kThreads) megakernel(Params p) {
  trace_path<kTransmissive, kEnvNee, false>(p);
}

// The BVH tier (B1d), kBvhMinBlocks blocks per SM.
template <bool kTransmissive, bool kEnvNee>
__global__ void __launch_bounds__(kThreads, kBvhMinBlocks)
    megakernel_bvh(Params p) {
  trace_path<kTransmissive, kEnvNee, true>(p);
}

template <bool kTransmissive, bool kEnvNee>
void launch_tier(const Params& p, bool bvh, int blocks, size_t smem,
                 cudaStream_t st) {
  if (bvh) {
    megakernel_bvh<kTransmissive, kEnvNee><<<blocks, kThreads, smem, st>>>(p);
  } else {
    megakernel<kTransmissive, kEnvNee><<<blocks, kThreads, smem, st>>>(p);
  }
}

}  // namespace

extern "C" int halogen_megakernel_launch(
    const float* origin, const float* direction, const float* far,
    const int* sample_idx, const int* seed, const float* tri,
    const float* trin, const float* sph, const float* mat,
    const float* nodes, const float* env_tab, float* out, int n,
    int num_tris, int num_spheres,
    int num_materials, int max_bounces, int lim_d, int lim_g, int lim_t,
    int sobol, int use_rr, int transmissive, int env_nee, int env_h,
    int env_w, int use_bvh, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (env_nee && (env_tab == nullptr || env_h <= 0 || env_w <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.origin = origin;
  p.direction = direction;
  p.far = far;
  p.sample_idx = reinterpret_cast<const uint32_t*>(sample_idx);
  p.seed = reinterpret_cast<const uint32_t*>(seed);
  if (use_bvh && nodes == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // on the BVH tier `tri` is the world BVH's [T, 12] slot-order table
  p.scene = {tri, trin, sph, mat, num_tris, num_spheres, num_materials,
             {reinterpret_cast<const float4*>(nodes),
              reinterpret_cast<const float4*>(tri), trin}};
  p.out = out;
  p.n = n;
  p.cfg = {0.0f,      max_bounces, lim_d,   lim_g, lim_t, sobol != 0,
           use_rr != 0, env_tab,   env_h, env_w};
  const size_t smem = sizeof(float) * scene_smem_floats(
                                          use_bvh ? 0 : num_tris, num_spheres,
                                          num_materials);
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bvh = use_bvh != 0;
  if (transmissive && env_nee) {
    launch_tier<true, true>(p, bvh, blocks, smem, st);
  } else if (transmissive) {
    launch_tier<true, false>(p, bvh, blocks, smem, st);
  } else if (env_nee) {
    launch_tier<false, true>(p, bvh, blocks, smem, st);
  } else {
    launch_tier<false, false>(p, bvh, blocks, smem, st);
  }
  return static_cast<int>(cudaGetLastError());
}
