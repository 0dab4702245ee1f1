// Closest hit and any hit over the world BVH, one thread per ray: the
// Hopper form of the JAX package's world-BVH traversal
// (`halogen_tpu/kernels/bvh_pallas.py::_traverse_kernel`, B3), used by the
// traversal kernel (traverse.cu) and by the megakernel's BVH tier
// (path_common.cuh, B1d, in place of the raylet tier
// `halogen_tpu/kernels/megakernel.py::_make_raylet_traversal`).
//
// The TPU kernel walks one shared stack per 1024-ray block, because its
// vector unit has no per-lane control flow; the treelet, flatlet and
// raylet kernels (B4-B6) are other answers to that constraint and to the
// 128-lane VMEM layout. A GPU thread has its own control flow, so here
// every ray walks the tree alone, as the reference HLSL did
// (HalgoenCompute.compute:378-472), testing a leaf's triangles with the
// brute tier's Möller-Trumbore (`triangle_hit`) and both children of an
// inner node with the slab test against the best t so far. A leaf tests
// all its triangles (the Pallas kernel stops at MAX_LEAF, which only an
// oversized leaf, left when the build's depth runs out, exceeds).
//
// What bounds it on this card: latency and divergence. Each step is a
// dependent load (a child pair: 64 bytes; a triangle: 48) followed by
// ~30-60 float ops, and a warp's rays part ways through the tree; the
// nodes and triangles (~1 MB for an 8.7k-triangle scene, ~8 MB for 78k)
// stay in the 50 MB L2. The bound of the work (bytes in and out, tests
// times their operations) is far under the walk's time: on an H100 80GB
// HBM3, 0.0059 ms against 0.55 ms of device time for the glass dragon's
// 262144 camera paths through B1b+d, 0.0045 against 0.076 ms for B3 on
// its camera rays (PERF.md §6). A loop that takes one node a trip, leaf
// or inner, makes a warp run its lanes' leaf tests and box tests one after
// the other in every trip. What the design does about it:
//   - "while-while" (Aila and Laine, "Understanding the efficiency of ray
//     traversal on GPUs", 2009): an inner loop walks inner nodes until the
//     lane holds a leaf, then the leaf's triangles are tested, so the
//     lanes of a warp test their leaves together;
//   - the near child that the ray hits is visited next without a push;
//     only the far one is pushed, as one 32-bit word (index_a << 8 |
//     count; a tree of depth 32 needs 32 entries), in a local array that
//     L1 holds;
//   - triangle rows of 12 floats, read as three 16-byte loads
//     (`triangle_hit` on a float4 row: the same ops in the same order as
//     on the brute tier's rows in shared memory, so every route still
//     agrees bit for bit on the same triangle).
// Measured slower and left out (PERF.md §6): the stack's first 8 or 16
// entries in shared memory, and culling popped entries by a stored entry
// distance (its store, load and branch cost more than the boxes it
// skips). The walk visits the nodes a one-node-a-trip stack walk with
// near-first order visits, in that order, so the same hit wins.

#pragma once

#include <stdint.h>

#include "geometry.cuh"

namespace halogen {

constexpr int kBvhStack = 64;  // entries: bvh_pallas.MAX_STACK
constexpr int kCountBits = 8;  // entry word: index_a << 8 | count
constexpr uint32_t kCountMask = (1u << kCountBits) - 1u;

// The world BVH in global memory (kernels/traverse.py, core/types.WorldBVH).
struct BvhView {
  const float4* nodes;  // [Nn, 2]: (lo.xyz, hi.x), (hi.yz, index_a, count)
  const float4* tri;    // [T, 3] in slot order: v0, e1, e2, 3 pad
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

// A node's entry word from its second float4 (index_a, count as floats).
__device__ __forceinline__ uint32_t entry_word(float4 b) {
  return (static_cast<uint32_t>(b.z) << kCountBits) |
         static_cast<uint32_t>(b.w);
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
  uint32_t stack[kBvhStack];  // pending far children; a push past the end
  int sp = 0;                 // is dropped, as the Pallas kernel's is
  uint32_t node = entry_word(__ldg(bv.nodes + 1));  // the root
  while (true) {
    // inner nodes, until the lane holds a leaf or the walk is over
    bool done = false;
    while (!(node & kCountMask)) {  // children index_a and index_a + 1
      const float4* c =
          bv.nodes + 2 * static_cast<size_t>(node >> kCountBits);
      const float4 a0 = __ldg(c), a1 = __ldg(c + 1);
      const float4 b0 = __ldg(c + 2), b1 = __ldg(c + 3);
      const float ea = node_entry(a0, a1, o, inv_d, h.t);
      const float eb = node_entry(b0, b1, o, inv_d, h.t);
      if constexpr (kCount) h.box_tests += 2;
      // a miss is INFINITY, so e_near is INFINITY only where both miss
      const bool a_first = ea <= eb;
      const float e_near = a_first ? ea : eb;
      const float e_far = a_first ? eb : ea;
      if (e_near < INFINITY) {
        if (e_far < INFINITY && sp < kBvhStack)
          stack[sp++] = entry_word(a_first ? b1 : a1);
        node = entry_word(a_first ? a1 : b1);
      } else if (sp > 0) {
        node = stack[--sp];
      } else {
        done = true;
        break;
      }
    }
    if (done) break;
    // a leaf: triangles index_a .. index_a + count - 1
    const int ia = static_cast<int>(node >> kCountBits);
    const int ct = static_cast<int>(node & kCountMask);
    if constexpr (kCount) h.tri_tests += ct;
    for (int k = 0; k < ct; ++k) {
      float t, u, v, det;
      if (triangle_hit(bv.tri + static_cast<size_t>(ia + k) * kTriRow4, o, d,
                       t, u, v, det) &&
          t < h.t) {
        h.t = t;
        h.u = u;
        h.v = v;
        h.det = det;
        h.slot = ia + k;
        if constexpr (kAnyHit) return true;
      }
    }
    if (sp == 0) break;
    node = stack[--sp];
  }
  return h.slot >= 0;
}

}  // namespace halogen
