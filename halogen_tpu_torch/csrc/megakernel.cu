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
//   B1b nested dielectrics: a per-thread medium stack of 8 material ids
//       (any_transmissive=True);
//   B1c env NEE: an envmap draw and a shadow ray per bounce, 12 outputs
//       (env_nee=True), alone or with B1b;
//   B1d the BVH tier (scenes over the brute tier's 128 triangles): each of
//       the above with the closest hit and the shadow ray walking the
//       world BVH (bvh_traverse.cuh) in global memory, in place of the
//       Pallas kernel's raylet tier (`_make_raylet_traversal`, :523); a
//       kernel of its own, `megakernel_bvh`, for its launch bounds;
//   B1e area-light NEE (light_nee=True): each of the above with a light
//       drawn from the light table and a shadow ray per bounce (on the
//       BVH tier an any-hit walk, path_common.cuh `light_visible`),
//       `megakernel_light` and `megakernel_bvh_light` (kernels of
//       their own, so that the other variants keep their names). The
//       Pallas kernel has no such variant (`megakernel.py:1622-1635`); it
//       replaces the JAX lockstep's light NEE, `trace.py:200-229, 332-432`;
//       `megakernel_bvh_light_probe` is B1e+d counting its shadow walks
//       under both rules (`LightProbe`), `megakernel_light_probe` B1e
//       counting its shadow scans with and without the cull, measurements,
//       never a render's;
//   kRecord, on both tiers (`megakernel_record`, `megakernel_bvh_record`),
//       where a gradient follows on the record route (`kernels/adjoint.py`
//       record_plan): each shaded bounce also writes the transcript the
//       adjoint's sweep reads (`RecordView`, path_common.cuh; 20 bytes, 48
//       with env NEE, 16 more with light NEE) and each path one word, so
//       that the backward (adjoint.cu `adjoint_sweep`) need not trace the
//       path again. The stores are indexed by ray and slot-major: coalesced
//       where a thread holds one ray (the BVH tier's glass variants),
//       scattered where lanes refill (every brute-tier variant). With
//       area-light NEE the recording kernels are kernels of their own,
//       `megakernel_light_record` and `megakernel_bvh_light_record` (B2+l's
//       forward): they also write the emission's MIS weight at each hit and
//       the light term's factors and material (the JAX package
//       differentiates light NEE only through its lockstep).
// The sky itself is shaded after the kernel, once per ray, from the miss
// record (`kernels/megakernel.py`), as the Pallas wrapper does.
//
// What bounds it on this card: instruction issue, then the unevenness of
// the paths. A launch moves little through device memory: from pixels a
// ray costs 8 bytes in (its pixel; the camera block is 96 bytes a launch)
// and 40 out (48 with env NEE), and the scene tables are read once a
// block. Each ray-bounce runs about 14 primitive tests (12 triangles and
// 2 spheres of the Cornell box; twice that with B1c's shadow ray), one
// material lookup and five sampler draws. The paths end unevenly: a
// Cornell ray takes 2.3 trips of the loop on average while the longest of
// each 32 takes 5.2 (glass 2.7 and 7.3, the sky scene 1.7 and 3.0;
// chip_smoke.py phase 24), so a warp that waits for its longest path idles
// over half its lanes. What the design does about each:
//   - the kernel makes its own rays. With a camera block (`CameraView`)
//     thread i takes pixel pix[i / spp_block] and lane i % spp_block,
//     hashes the pixel into its seed and runs `camera_ray`
//     (path_common.cuh): two 2D draws and ~90 float ops, each rounded as
//     `camera.generate_rays` rounds it on the card. On the TPU the jit
//     fuses that work beside the Pallas call; eager PyTorch issues it as
//     ~1,050 launches a group, which kept the card idle 71-88% of a
//     frame. A frame's group is now one launch (and the sky pass where
//     there is an envmap). Where a gradient is wanted the rays are also
//     written out, for the adjoint's replay. Without the block the kernel
//     reads explicit rays (32 bytes a ray), for callers that have them.
//   - warps are persistent and refill ("replacing terminated rays", Aila
//     and Laine 2009): the grid is as many blocks as the card holds at
//     once, a warp draws ray indices from one global counter, and as
//     soon as one of its lanes is free (its ray's outputs stored) the
//     free lanes take new rays; the bounce index is per lane. Outputs are indexed by ray and a ray's result does not
//     depend on its lane, so the bits are those of one ray a thread
//     (`counter` null: that order, kept for the comparison). Refilling as
//     soon as any lane is free measured fastest on the brute tier
//     (B1a 0.117 -> 0.083 ms, B1b 0.200 -> 0.120, B1c 0.179 -> 0.141 a
//     262144-ray launch; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).
//     The glass variants of the BVH tier run without it: their walk wants
//     the coherent rays of neighbouring pixels more than full warps.
//   - the sampler (path_common.cuh): Sobol's dimension 1 is Pascal's
//     triangle mod 2, so its 32 table rows are five butterfly steps, and
//     the bit reversals that met between it, the index shuffle and the
//     Owen scramble cancel. An Owen-scrambled 2D draw is ~70 integer ops;
//     the 32 rows of a direction table would alone be ~130.
//   - B1b's medium stack is 8 material ids in one 64-bit word: every field
//     of a medium is a column of its material's row in shared memory, a
//     push inserts a byte and a pop deletes one. As 8 slots x 6 fields
//     the stack takes 48 registers (126-128 in all, 4 blocks an SM); so
//     B1b fits 89 (5 blocks an SM).
//   - triangle rows are 12 floats, read from shared memory as three
//     16-byte loads (the BVH tier's layout); every thread of a warp that
//     tests the same triangle reads the same address, which the
//     shared-memory crossbar broadcasts.
//   - B1c's env draw is one 64-byte row of the [H*W, 16] draw table (four
//     16-byte loads through the read-only path, cached in L1 and L2),
//     which also holds the direction of the texel and of its alias, so a
//     draw computes no sine or cosine. The TPU kernel took its env draws
//     precomputed as a [7, K, N] table, because gathers are costly there;
//     here the draw runs in the kernel.
//   - each block copies the scene tables into shared memory once; blocks
//     of 128 threads, no padding of the ray count.
// B1e adds to each shaded opaque bounce a 1D and a 2D draw, a binary
// search of the light table's CDF column (log2 L dependent loads, 64 bytes
// apart; a 4-light table is one cache line, the testing scene's 77k
// triangles' table a few KB of it in L1/L2), one 64-byte row, ~120 float
// ops (the point or cone direction, the pdfs and the weight) and a
// shadow ray. On the brute tier the shadow ray tests a triangle only
// where its segment can cross the triangle's plane (path_common.cuh
// `shadow_tris`: two dot products with the normal the row carries, ~27
// ops, in place of Möller-Trumbore's ~55 on a triangle it cannot hit; a
// Cornell shadow segment runs inside the box, short of the panel, so it
// crosses none; the spheres keep their test). On the BVH tier the
// light's own triangle and an any-hit walk in front of it, which stops at
// the first blocker (a closest-hit walk, as before, went on down the tree
// past it; PERF.md §6 has both walks' tests and times, and B1e's split).
// B1d is bound by the walk instead: a dependent node or leaf load per step
// (latency; the ~1 MB of nodes and triangles of an 8.7k-triangle scene
// stay in L2) and the divergence of a warp's rays through the tree,
// which grows after the first bounce as glass rays refract and reflect
// (bvh_traverse.cuh says what the walk does about it). Its variants ask
// for kBvhMinBlocks = 4 blocks per SM (`__launch_bounds__`).
// Measured and left out (PERF.md §6): `__launch_bounds__` that force 5-8
// blocks an SM on the brute tier (spills; slower or equal), and
// `camera_ray` out of line (B1a slower).
// The tables come in as pointers, not __constant__ symbols, and the ray
// counter is a [1] tensor the wrapper zeroes on the stream, so launches
// are re-entrant.
//
// Build with -fmad=false and without fast math so each op rounds as the
// plain PyTorch version's does.

#include "path_common.cuh"

namespace {

using namespace halogen;

// blocks of 128 threads per SM that the BVH tier's variants must fit
constexpr int kBvhMinBlocks = 4;
constexpr unsigned kFullWarp = 0xffffffffu;

struct Params {
  // Explicit rays (cam.cam null), read; or, with a camera block, buffers
  // the kernel writes its own rays to (null: not wanted)
  float* origin;         // [N, 3]
  float* direction;      // [N, 3]
  uint32_t* sample_idx;  // [N]
  uint32_t* seed;        // [N]
  const float* far;      // [1]
  CameraView cam;
  SceneView scene;       // global-memory tables
  float* out;            // [N, 10], or [N, 12] with env NEE
  LightView light;       // light NEE's tables (B1e)
  RecordView rec;        // the transcript for the adjoint (kRecord)
  // the light-NEE probe's [N, kProbeWords] counters and mode (kProbe)
  int* probe;
  int probe_mode;
  // [1], zero at launch: the next ray to hand out (warps draw their rays
  // from it); null: thread t of the grid takes ray t
  int* counter;
  int n;
  PathConfig cfg;
};

// Ray i of the launch into `s`: read, or made from the camera block.
__device__ __forceinline__ void load_ray(const Params& p, int i, PathState& s,
                                         uint32_t& sidx, uint32_t& seed) {
  if (p.cam.cam != nullptr) {
    const PrimaryRay r = camera_ray(p.cam, p.cfg.sobol, i);
    s.o = r.o;
    s.d = r.d;
    sidx = r.sidx;
    seed = r.seed;
    if (p.origin != nullptr) {  // for the adjoint's replay
      p.origin[3 * i] = r.o.x;
      p.origin[3 * i + 1] = r.o.y;
      p.origin[3 * i + 2] = r.o.z;
      p.direction[3 * i] = r.d.x;
      p.direction[3 * i + 1] = r.d.y;
      p.direction[3 * i + 2] = r.d.z;
      p.sample_idx[i] = sidx;
      p.seed[i] = seed;
    }
  } else {
    s.o = {p.origin[3 * i], p.origin[3 * i + 1], p.origin[3 * i + 2]};
    s.d = {p.direction[3 * i], p.direction[3 * i + 1],
           p.direction[3 * i + 2]};
    sidx = p.sample_idx[i];
    seed = p.seed[i];
  }
}

template <bool kEnvNee>
__device__ __forceinline__ void store_path(const Params& p, int i,
                                           const PathState& s) {
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

// The paths of this block's warps, into p.out. A lane holds one ray at a
// time and takes it one bounce a trip; as soon as a lane of the warp is
// free, the free lanes take the next rays of the launch ("replacing
// terminated rays", Aila and Laine 2009). A ray's result does not depend
// on its lane. With kRecord the lane also writes each shaded bounce's
// transcript and, at the path's end, its shaded count and miss flag to
// p.rec, indexed by ray, for the sweep-only adjoint. With kProbe it
// counts its light shadow walks (`LightProbe`) into p.probe, by ray.
template <bool kTransmissive, bool kEnvNee, bool kBvh, bool kLightNee,
          bool kRecord = false, bool kProbe = false>
__device__ __forceinline__ void trace_path(const Params& p) {
  extern __shared__ float4 smem4[];
  const SceneView sc =
      load_scene<kBvh>(p.scene, reinterpret_cast<float*>(smem4));
  __syncthreads();

  PathConfig cfg = p.cfg;
  cfg.far = p.far[0];
  const unsigned lane = threadIdx.x & 31u;
  PathState s;
  BounceRecord rec;
  LightProbe probe;
  uint32_t sidx = 0u, seed = 0u;
  int ray = -1;      // the ray this lane holds, -1: none
  int k = 0;         // its next bounce
  bool more = true;  // the launch may have rays not handed out (per warp)
  while (true) {
    unsigned live = __ballot_sync(kFullWarp, ray >= 0);
    if (more && live != kFullWarp) {
      int next;
      if (p.counter != nullptr) {
        const unsigned free_lanes = ~live;
        int base = 0;
        if (lane == 0u) base = atomicAdd(p.counter, __popc(free_lanes));
        base = __shfl_sync(kFullWarp, base, 0);
        next = base + __popc(free_lanes & ((1u << lane) - 1u));
        more = base + __popc(free_lanes) < p.n;
      } else {
        next = blockIdx.x * blockDim.x + threadIdx.x;
        more = false;
      }
      if (ray < 0 && next < p.n) {
        ray = next;
        k = 0;
        s = PathState();
        if constexpr (kTransmissive) s.stack.init();
        if constexpr (kProbe) probe = LightProbe{p.probe_mode, {}};
        load_ray(p, ray, s, sidx, seed);
      }
      live = __ballot_sync(kFullWarp, ray >= 0);
    }
    if (live == 0u) break;
    if (ray >= 0) {
      const int res =
          path_bounce<kTransmissive, kEnvNee, kBvh, kLightNee, kProbe>(
              sc, cfg, sidx, seed, k, s, rec, p.light,
              kProbe ? &probe : nullptr);
      const bool shaded = res == kShadedEnded || res == kShadedGoesOn;
      if constexpr (kRecord) {
        if (shaded) record_bounce<kEnvNee, kLightNee>(p.rec, ray, k, rec);
      }
      ++k;
      if (res != kShadedGoesOn || k > cfg.max_bounces) {
        store_path<kEnvNee>(p, ray, s);
        if constexpr (kRecord) {
          p.rec.end[ray] = static_cast<uint32_t>(shaded ? k : k - 1) |
                           (res == kMissed ? kEndMissed : 0u);
        }
        if constexpr (kProbe) {
#pragma unroll
          for (int j = 0; j < kProbeWords; ++j)
            p.probe[static_cast<size_t>(ray) * kProbeWords + j] =
                probe.count[j];
        }
        ray = -1;
      }
    }
  }
}

// The brute tier (B1a-c).
template <bool kTransmissive, bool kEnvNee>
__global__ void __launch_bounds__(kThreads) megakernel(Params p) {
  trace_path<kTransmissive, kEnvNee, false, false>(p);
}

// The brute tier recording the adjoint's transcript (B1a-c with kRecord).
template <bool kTransmissive, bool kEnvNee>
__global__ void __launch_bounds__(kThreads) megakernel_record(Params p) {
  trace_path<kTransmissive, kEnvNee, false, false, true>(p);
}

// The BVH tier (B1d), kBvhMinBlocks blocks per SM.
template <bool kTransmissive, bool kEnvNee>
__global__ void __launch_bounds__(kThreads, kBvhMinBlocks)
    megakernel_bvh(Params p) {
  trace_path<kTransmissive, kEnvNee, true, false>(p);
}

// The BVH tier recording the adjoint's transcript (B1d with kRecord).
template <bool kTransmissive, bool kEnvNee>
__global__ void __launch_bounds__(kThreads, kBvhMinBlocks)
    megakernel_bvh_record(Params p) {
  trace_path<kTransmissive, kEnvNee, true, false, true>(p);
}

// Light NEE (B1e) on the brute tier and on the BVH tier (B1e+d).
template <bool kTransmissive, bool kEnvNee>
__global__ void __launch_bounds__(kThreads) megakernel_light(Params p) {
  trace_path<kTransmissive, kEnvNee, false, true>(p);
}

template <bool kTransmissive, bool kEnvNee>
__global__ void __launch_bounds__(kThreads, kBvhMinBlocks)
    megakernel_bvh_light(Params p) {
  trace_path<kTransmissive, kEnvNee, true, true>(p);
}

// Light NEE recording the adjoint's transcript with the light term (B1e
// and B1e+d with kRecord; B2+l's forward).
template <bool kTransmissive, bool kEnvNee>
__global__ void __launch_bounds__(kThreads) megakernel_light_record(Params p) {
  trace_path<kTransmissive, kEnvNee, false, true, true>(p);
}

template <bool kTransmissive, bool kEnvNee>
__global__ void __launch_bounds__(kThreads, kBvhMinBlocks)
    megakernel_bvh_light_record(Params p) {
  trace_path<kTransmissive, kEnvNee, true, true, true>(p);
}

// B1e+d without env NEE counting its light shadow walks (the probe).
template <bool kTransmissive>
__global__ void __launch_bounds__(kThreads, kBvhMinBlocks)
    megakernel_bvh_light_probe(Params p) {
  trace_path<kTransmissive, false, true, true, false, true>(p);
}

// B1e without env NEE counting its light shadow tests, the full scan and
// the culled one (the brute tier's probe).
template <bool kTransmissive>
__global__ void __launch_bounds__(kThreads) megakernel_light_probe(Params p) {
  trace_path<kTransmissive, false, false, true, false, true>(p);
}

// Launches `kernel`: one thread a ray without a counter; with one, as many
// blocks as the card holds at once (never more than the rays need).
template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, size_t smem,
                   cudaStream_t st) {
  int blocks = (p.n + kThreads - 1) / kThreads;
  if (p.counter != nullptr) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidValue;
    blocks = min(blocks, per_sm * sms);
  }
  kernel<<<blocks, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool kTransmissive, bool kEnvNee>
cudaError_t launch_tier(const Params& p, bool bvh, bool light, bool record,
                        size_t smem, cudaStream_t st) {
  if (record && light) {
    if (bvh)
      return launch(megakernel_bvh_light_record<kTransmissive, kEnvNee>, p,
                    smem, st);
    return launch(megakernel_light_record<kTransmissive, kEnvNee>, p, smem,
                  st);
  }
  if (record) {
    if (bvh)
      return launch(megakernel_bvh_record<kTransmissive, kEnvNee>, p, smem,
                    st);
    return launch(megakernel_record<kTransmissive, kEnvNee>, p, smem, st);
  }
  if (p.probe != nullptr) {
    if constexpr (kEnvNee) {
      return cudaErrorInvalidValue;
    } else {
      if (bvh)
        return launch(megakernel_bvh_light_probe<kTransmissive>, p, smem,
                      st);
      return launch(megakernel_light_probe<kTransmissive>, p, smem, st);
    }
  }
  if (light) {
    if (bvh)
      return launch(megakernel_bvh_light<kTransmissive, kEnvNee>, p, smem,
                    st);
    return launch(megakernel_light<kTransmissive, kEnvNee>, p, smem, st);
  }
  if (bvh) return launch(megakernel_bvh<kTransmissive, kEnvNee>, p, smem, st);
  return launch(megakernel<kTransmissive, kEnvNee>, p, smem, st);
}

}  // namespace

// Rays: explicit (`cam` null; origin, direction, sample_idx and seed are
// read) or made by the kernel from the camera block (`cam` [24], `pix`
// [n / spp_block], `frame` [1], width, height, spp_block, lane0, spp; the
// four ray buffers are then written when origin is not null). `counter`
// ([1] int32, zero) selects persistent warps that refill; null: one ray
// a thread. With light_nee, `light_rows` [num_lights, 16] and `light_dens`
// [num_tris + num_spheres] (`LightView`). `rec_a` not null: record the
// adjoint's transcript (either tier): `rec_a` [B + 1, n] float4,
// `rec_word` [B + 1, n], `rec_end` [n], with env NEE also `rec_nq` [B + 1,
// n] float4, `rec_ngw` [B + 1, n] float2 and `rec_texel` [B + 1, n], with
// light NEE `rec_lq` [B + 1, n] float4 (`RecordView`). `probe` not null
// (either tier, with light NEE
// and without env NEE): the light-NEE probe, [n, kProbeWords] counters,
// `probe_mode` a `ProbeMode`.
extern "C" int halogen_megakernel_launch(
    float* origin, float* direction, const float* far, int* sample_idx,
    int* seed, const float* tri, const float* trin, const float* sph,
    const float* mat, const float* nodes, const float* env_tab, float* out,
    const float* cam, const long long* pix, const int* frame, int* counter,
    const float* light_rows, const float* light_dens, float* rec_a,
    int* rec_word, float* rec_nq, float* rec_ngw, int* rec_texel,
    int* rec_end, float* rec_lq, int* probe, int n, int num_tris,
    int num_spheres, int num_materials, int max_bounces, int lim_d,
    int lim_g, int lim_t, int sobol, int use_rr, int transmissive,
    int env_nee, int env_h, int env_w, int use_bvh, int width, int height,
    int spp_block, int lane0, int spp, int light_nee, int num_lights,
    int probe_mode, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (env_nee && (env_tab == nullptr || env_h <= 0 || env_w <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (light_nee &&
      (light_rows == nullptr || light_dens == nullptr || num_lights <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cam != nullptr ? (pix == nullptr || frame == nullptr || width <= 0 ||
                        height <= 0 || spp_block <= 0)
                     : (origin == nullptr || direction == nullptr ||
                        sample_idx == nullptr || seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (use_bvh && nodes == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool record = rec_a != nullptr;
  if (record && (rec_word == nullptr || rec_end == nullptr ||
                 (env_nee && (rec_nq == nullptr || rec_ngw == nullptr ||
                              rec_texel == nullptr)) ||
                 (light_nee && rec_lq == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (probe != nullptr &&
      (!light_nee || env_nee || record || probe_mode < 0 ||
       probe_mode > kProbeNone))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.origin = origin;
  p.direction = direction;
  p.sample_idx = reinterpret_cast<uint32_t*>(sample_idx);
  p.seed = reinterpret_cast<uint32_t*>(seed);
  p.far = far;
  p.cam = {cam,   pix,       reinterpret_cast<const uint32_t*>(frame),
           width, height,    spp_block,
           lane0, spp};
  // on the BVH tier `tri` is the world BVH's [T, 12] slot-order table
  p.scene = {tri, trin, sph, mat, num_tris, num_spheres, num_materials,
             {reinterpret_cast<const float4*>(nodes),
              reinterpret_cast<const float4*>(tri), trin}};
  p.out = out;
  p.light = {reinterpret_cast<const float4*>(light_rows), light_dens,
             num_lights, num_tris};
  p.rec = {reinterpret_cast<float4*>(rec_a),
           reinterpret_cast<uint32_t*>(rec_word),
           reinterpret_cast<float4*>(rec_nq),
           reinterpret_cast<float2*>(rec_ngw),
           rec_texel,
           reinterpret_cast<uint32_t*>(rec_end),
           n,
           reinterpret_cast<float4*>(rec_lq)};
  p.probe = probe;
  p.probe_mode = probe_mode;
  p.counter = counter;
  p.n = n;
  p.cfg = {0.0f,      max_bounces, lim_d,   lim_g, lim_t, sobol != 0,
           use_rr != 0, reinterpret_cast<const float4*>(env_tab), env_h,
           env_w};
  const size_t smem = sizeof(float) * scene_smem_floats(
                                          use_bvh ? 0 : num_tris, num_spheres,
                                          num_materials);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bvh = use_bvh != 0, light = light_nee != 0;
  cudaError_t err;
  if (transmissive && env_nee) {
    err = launch_tier<true, true>(p, bvh, light, record, smem, st);
  } else if (transmissive) {
    err = launch_tier<true, false>(p, bvh, light, record, smem, st);
  } else if (env_nee) {
    err = launch_tier<false, true>(p, bvh, light, record, smem, st);
  } else {
    err = launch_tier<false, false>(p, bvh, light, record, smem, st);
  }
  return static_cast<int>(err);
}
