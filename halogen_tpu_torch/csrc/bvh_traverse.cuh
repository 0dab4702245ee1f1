// Closest hit and any hit over the world BVH, one thread per ray with a
// per-thread stack: the Hopper form of the JAX package's world-BVH
// traversal (`halogen_tpu/kernels/bvh_pallas.py::_traverse_kernel`, B3),
// used by the traversal kernel (traverse.cu) and by the megakernel's BVH
// tier (path_common.cuh, B1d).
//
// The TPU kernel walks one shared stack per 1024-ray block, because its
// vector unit has no per-lane control flow; the treelet, flatlet and
// raylet kernels (B4-B6) are other answers to that constraint and to the
// 128-lane VMEM layout. A GPU thread has its own control flow, so here
// every ray walks the tree alone, as the reference HLSL did
// (HalgoenCompute.compute:378-472): pop a node, test a leaf's triangles
// with the brute tier's Möller-Trumbore (`triangle_hit`), or slab-test
// both children against the best t so far and push the far one first so
// the near one pops first. A leaf tests all its triangles (the Pallas
// kernel stops at MAX_LEAF, which only an oversized leaf, left when the
// build's depth runs out, exceeds).
//
// What bounds it on this card: memory latency. Each step is a dependent
// load (a node pair: 64 bytes, or a leaf's up to 5 x 36 bytes of
// triangles) followed by ~30 float ops; warps diverge once their rays'
// paths through the tree part. The nodes and triangles (~1 MB for an
// 8.7k-triangle scene, ~8 MB for 78k) stay in the 50 MB L2, read through
// the read-only path (`__ldg`). The stack is 64 entries of (index_a,
// count): dynamically indexed, so it lives in local memory (L1).

#pragma once

#include "geometry.cuh"

namespace halogen {

constexpr int kBvhStack = 64;  // bvh_pallas.MAX_STACK; a depth-32 tree needs 33

// The world BVH in global memory (kernels/traverse.py, core/types.WorldBVH).
struct BvhView {
  const float4* nodes;  // [Nn, 2]: (lo.xyz, hi.x), (hi.yz, index_a, count)
  const float* tri;     // [T, 9] in leaf (slot) order: v0, e1, e2
  const float* trin;    // [T, 10] in slot order: n0, n1 - n0, n2 - n0, mat
};

// The best hit of a walk: t is the bound the walk prunes against (the
// seed on entry), slot = -1 until a triangle wins.
struct BvhHit {
  float t, u, v, det;
  int slot;
  int tri_tests, box_tests;
};

// Entry distance into the node's box (the slab test of
// HalgoenCompute.compute:244-259, as in `sphere_t`), or INFINITY when
// the ray misses the box or enters it at or past `limit`.
__device__ __forceinline__ float node_entry(float4 a, float4 b, V3 o,
                                            V3 inv_d, float limit) {
  const float t1x = (a.x - o.x) * inv_d.x;
  const float t2x = (a.w - o.x) * inv_d.x;
  const float t1y = (a.y - o.y) * inv_d.y;
  const float t2y = (b.x - o.y) * inv_d.y;
  const float t1z = (a.z - o.z) * inv_d.z;
  const float t2z = (b.y - o.z) * inv_d.z;
  const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                           fminf(t1z, t2z));
  const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                           fmaxf(t1z, t2z));
  return (tmax > fmaxf(0.0f, tmin) && tmin < limit) ? tmin : INFINITY;
}

// Walks the tree from the root. Closest hit (kAnyHit = false): keeps in
// `h` the nearest triangle with HIT_EPS < t < h.t (strict `<`: the first
// one met wins a tie). Any hit (kAnyHit = true): returns true at the
// first triangle with HIT_EPS < t < h.t, which is then in `h`.
// kCount adds the triangle and box tests to `h`'s counters.
template <bool kAnyHit, bool kCount>
__device__ __forceinline__ bool bvh_walk(const BvhView& bv, V3 o, V3 d,
                                         BvhHit& h) {
  const V3 inv_d = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  int st_ia[kBvhStack], st_ct[kBvhStack];
  const float4 root = __ldg(bv.nodes + 1);
  st_ia[0] = static_cast<int>(root.z);
  st_ct[0] = static_cast<int>(root.w);
  int sp = 1;
  while (sp > 0) {
    --sp;
    const int ia = st_ia[sp], ct = st_ct[sp];
    if (ct > 0) {  // leaf: triangles ia .. ia + ct - 1
      if constexpr (kCount) h.tri_tests += ct;
      for (int k = 0; k < ct; ++k) {
        float t, u, v, det;
        if (triangle_hit(bv.tri + static_cast<size_t>(ia + k) * kTriStride,
                         o, d, t, u, v, det) &&
            t < h.t) {
          h.t = t;
          h.u = u;
          h.v = v;
          h.det = det;
          h.slot = ia + k;
          if constexpr (kAnyHit) return true;
        }
      }
    } else {  // inner: children ia and ia + 1
      const float4* c = bv.nodes + 2 * static_cast<size_t>(ia);
      const float4 a0 = __ldg(c), a1 = __ldg(c + 1);
      const float4 b0 = __ldg(c + 2), b1 = __ldg(c + 3);
      const float ea = node_entry(a0, a1, o, inv_d, h.t);
      const float eb = node_entry(b0, b1, o, inv_d, h.t);
      if constexpr (kCount) h.box_tests += 2;
      const bool a_first = ea <= eb;  // push far first: near pops first
      const float e_far = a_first ? eb : ea;
      const float e_near = a_first ? ea : eb;
      const float4 p_far = a_first ? b1 : a1;
      const float4 p_near = a_first ? a1 : b1;
      if (e_far < INFINITY && sp < kBvhStack) {
        st_ia[sp] = static_cast<int>(p_far.z);
        st_ct[sp] = static_cast<int>(p_far.w);
        ++sp;
      }
      if (e_near < INFINITY && sp < kBvhStack) {
        st_ia[sp] = static_cast<int>(p_near.z);
        st_ct[sp] = static_cast<int>(p_near.w);
        ++sp;
      }
    }
  }
  return h.slot >= 0;
}

}  // namespace halogen
