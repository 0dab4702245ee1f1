// Seeded closest hit over the world BVH for NVIDIA Hopper (sm_90a).
//
// Replaces `halogen_tpu/kernels/bvh_pallas.py::_traverse_kernel` (B3,
// through `traverse_world_bvh` / `traverse_world_bvh_any`) and, by the
// same contract, the treelet, flatlet and raylet kernels (B4
// `treelet_bvh.py::_traverse_kernel`, B5 `flatlet.py::_flatlet_kernel`,
// B6 `raylet.py::_raylet_kernel`): rays [N, 3] and a best-t seed [N] in;
// t (+inf on a miss), the global triangle id (through tri_map; -1 on a
// miss), u, v, the determinant's sign, and the triangle and box tests of
// each ray out. A hit needs HIT_EPS < t < seed, so a ray seeded at or
// below HIT_EPS (a dead lane, seed < 0) hits nothing and is not walked.
//
// One thread per ray, blocks of 128 threads, the walk of
// bvh_traverse.cuh (`bvh_walk`: while-while, near child first, a local
// stack of far children). What bounds it:
// the dependent loads of the walk (latency), and warp divergence among
// incoherent rays; the tables stay in L2 (see the header for what the
// walk does about it). Built with -fmad=false like the megakernel, so a
// hit's t, u and v are the brute tier's bits.

#include <stdint.h>

#include "bvh_traverse.cuh"

namespace {

using namespace halogen;

constexpr int kTraverseThreads = 128;

struct Params {
  const float* origin;   // [N, 3]
  const float* direction;  // [N, 3]
  const float* seed;     // [N]
  BvhView bvh;
  const int* tri_map;    // [T] slot -> global triangle id
  float* t;              // [N]
  int* tri;              // [N]
  float* u;              // [N]
  float* v;              // [N]
  float* sign;           // [N]
  int* tri_tests;        // [N]
  int* box_tests;        // [N]
  int n;
};

__global__ void __launch_bounds__(kTraverseThreads) traverse_kernel(Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const V3 o = {p.origin[3 * i], p.origin[3 * i + 1], p.origin[3 * i + 2]};
  const V3 d = {p.direction[3 * i], p.direction[3 * i + 1],
                p.direction[3 * i + 2]};
  BvhHit h = {p.seed[i], 0.0f, 0.0f, 0.0f, -1, 0, 0};
  const bool hit = h.t > kHitEps && bvh_walk<false, true>(p.bvh, o, d, h);
  p.t[i] = hit ? h.t : INFINITY;
  p.tri[i] = hit ? __ldg(p.tri_map + h.slot) : -1;
  p.u[i] = hit ? h.u : 0.0f;
  p.v[i] = hit ? h.v : 0.0f;
  p.sign[i] = hit ? sign_of(h.det) : 0.0f;
  p.tri_tests[i] = h.tri_tests;
  p.box_tests[i] = h.box_tests;
}

}  // namespace

extern "C" int halogen_traverse_launch(
    const float* origin, const float* direction, const float* seed,
    const float* nodes, const float* tri, const int* tri_map, float* t,
    int* tri_out, float* u, float* v, float* sign, int* tri_tests,
    int* box_tests, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.origin = origin;
  p.direction = direction;
  p.seed = seed;
  p.bvh = {reinterpret_cast<const float4*>(nodes),
           reinterpret_cast<const float4*>(tri), nullptr};
  p.tri_map = tri_map;
  p.t = t;
  p.tri = tri_out;
  p.u = u;
  p.v = v;
  p.sign = sign;
  p.tri_tests = tri_tests;
  p.box_tests = box_tests;
  p.n = n;
  const int blocks = (n + kTraverseThreads - 1) / kTraverseThreads;
  traverse_kernel<<<blocks, kTraverseThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
