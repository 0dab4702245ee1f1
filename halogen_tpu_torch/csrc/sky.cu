// The sky at the miss for NVIDIA Hopper (sm_90a): the forward kernel and
// its backward, which sums every texel's cotangent in a fixed order.
//
// Replaces the sky pass after the fused megakernel, which the JAX package
// leaves to XLA (`halogen_tpu/integrator/trace.py:460-482`,
// `halogen_tpu/kernels/megakernel.py:1868-1900` with
// `scene/envmap.py::sample_env_packed` and its vjp), and whose plain
// PyTorch version (`integrator/trace.py::deferred_sky`) takes ~150 eager
// launches a group. The kernels:
//   sky_forward: per ray, the trilinear lookup of the mip pyramid at the
//     recorded miss direction and mip-bias level (`_trilinear`,
//     `_bilin_atlas`: texel centres at (i + 0.5) / size, u wraps, v
//     clamps), times the miss attenuation and, with env NEE, the balance
//     weight against the env draw's pdf (`trace.env_mis_weight`), added
//     to the path color: [N, 3];
//   sky_backward_taps: per ray, for the cotangent ct of its color, the
//     cotangents the adjoint takes (of the miss attenuation, ct * w * sky,
//     and of the accumulated roughness, through the level's blend between
//     two mips) and the ray's eight taps of the lookup (four bilinear taps
//     in each of two mips), each a texel of the flat atlas of all mips
//     and its share of ct * w * matten. A block stages its 2,048 taps in
//     shared memory and stores them as 16-byte vectors, contiguous across
//     the block, and can count their first radix digit: its taps are a
//     tile of the ordering's first pass;
//   sky_radix_count, sky_radix_scan, sky_radix_scatter: the ordering, a
//     stable LSD radix sort of the taps by texel over only the bits the
//     atlas needs (14 for the gradient sky), at most 8 bits a pass: per
//     tile of 2,048 keys a digit histogram, a scan of them in digit then
//     tile order, and a stable scatter whose in-tile ranks come from
//     __match_any_sync. The first pass drops the keys outside
//     [0, n_texels) (-1: a ray that never reached the sky) and moves each
//     key's tap index (int32) with it; the order is that of a stable sort,
//     so each texel's run stays in tap (ray) order;
//   sky_reduce_texels: the per-texel sums of the ordered taps (and of the
//     adjoint's env-NEE records), a reduce-by-key over tiles of 512 taps a
//     warp: a lane adds its 16 consecutive taps one after another, a
//     segmented scan across the lanes (a fixed tree) joins a run that
//     crosses lanes; a run inside a tile is written whole, the tile's first
//     and last runs go to two carry slots, which the next launch reduces
//     the same way, in tile order, until one tile is left. No searches, no
//     work for an empty texel (a memset zeroes the output first; or each
//     run is added to it, where a chunk node's groups sum into one
//     gradient), no float atomics: two calls give the same bits.
// The taps follow the footprint-packed lookup the plain version
// differentiates (`pack_footprint`): above the first row's centre the
// weight of the second row is 0, and the second row is min(y0 + 1, H - 1).
//
// What bounds it on this card: memory. The forward reads 40 or 48 bytes of
// a ray's outputs and eight texels (cached: the pyramid of an envmap is
// small beside L2) and writes 12 bytes; the backward's taps write 128
// bytes a ray (a key and three weights a tap), the sort reads and writes
// 8 bytes a tap a pass, and the sums read 8 bytes a tap and gather its 12
// bytes of weights. Work per thread is bounded by a tile everywhere.
//
// Build with -fmad=false and without fast math, as megakernel.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMips = 16;
constexpr int kTaps = 8;
constexpr int kSortItems = 8;  // keys a thread in a sort pass
constexpr int kSortTile = kThreads * kSortItems;
constexpr int kMaxDigitBits = 8;
constexpr int kMaxRadix = 1 << kMaxDigitBits;
constexpr int kNoDigit = kMaxRadix;  // a key the pass does not move
constexpr int kSumItems = 16;        // consecutive keys a lane in the sums
constexpr int kSumTile = 32 * kSumItems;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kPi = 3.14159265358979323846f;

struct Mips {
  int n;  // levels, finest first
  int h[kMaxMips], w[kMaxMips];
  int off[kMaxMips];  // first texel of each level in the atlas
};

struct SkyParams {
  const float* outputs;  // [N, n_out]: color, miss atten, rough, dir (, pcos,
                         // nee flag)
  const float* atlas;    // [T, 3] every mip's texels, finest first
  const float* pdf;      // [pdf_h, pdf_w] env NEE's solid-angle pdf
  int n, n_out, pdf_h, pdf_w;
  bool bias, nee;
  float base_level, range;
  Mips mips;
};

// What the lookup of one ray needs: its direction's (u, v), the two mips,
// the blend and the level's clamp mask, and the MIS weight.
struct Lookup {
  float u, v, frac, w_mis;
  int l0, l1;
  bool level_moves;  // d level / d rough = range (else 0)
};

// `o` is the ray's row of outputs, in device memory or in registers.
__device__ __forceinline__ Lookup lookup(const SkyParams& p, const float* o) {
  // envmap.py dir_to_equirect_uv: normalize, atan2 for u, acos for v
  const float x0 = o[7], y0 = o[8], z0 = o[9];
  const float nrm = sqrtf(x0 * x0 + y0 * y0 + z0 * z0);
  const float x = x0 / nrm, y = y0 / nrm, z = z0 / nrm;
  Lookup L;
  L.u = atan2f(x, -z) / kTwoPi + 0.5f;
  L.v = acosf(fminf(fmaxf(y, -1.0f), 1.0f)) / kPi;
  const int n = p.mips.n;
  const float raw = p.bias ? p.base_level + o[6] * p.range : p.base_level;
  const float top = static_cast<float>(n - 1);
  const float level = fminf(fmaxf(raw, 0.0f), top);
  L.level_moves = p.bias && n > 1 && raw >= 0.0f && raw <= top;
  L.l0 = n == 1 ? 0 : min(max(static_cast<int>(floorf(level)), 0), n - 2);
  L.l1 = min(L.l0 + 1, n - 1);
  L.frac = level - static_cast<float>(L.l0);
  L.w_mis = 1.0f;
  if (p.nee && o[11] > 0.5f) {
    // envmap.py env_pdf: the texel the direction falls in
    const int px = min(max(static_cast<int>(L.u * p.pdf_w), 0), p.pdf_w - 1);
    const int py = min(max(static_cast<int>(L.v * p.pdf_h), 0), p.pdf_h - 1);
    const float pe = p.pdf[py * p.pdf_w + px];
    L.w_mis = o[10] / fmaxf(o[10] + pe, 1e-12f);
  }
  return L;
}

// The four taps of a bilinear lookup of mip l (`_bilin_atlas`, packed):
// texels c00, c01, c10, c11 of the atlas and the weights wx, wy.
__device__ __forceinline__ void bilinear(const Mips& m, int l, float u,
                                         float v, int (&t)[4], float& wx,
                                         float& wy) {
  const int h = m.h[l], w = m.w[l];
  const float fx = u * static_cast<float>(w) - 0.5f;
  const float fy = v * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(fx), y0 = floorf(fy);
  wx = fx - x0;
  wy = fy - y0;
  int x0i = static_cast<int>(x0) % w;
  if (x0i < 0) x0i += w;  // torch.remainder: the sign of the divisor
  const int x1i = x0i + 1 == w ? 0 : x0i + 1;
  const int y0u = static_cast<int>(y0);
  const int y0i = max(min(y0u, h - 1), 0);
  const int y1i = min(y0i + 1, h - 1);
  if (y0u < 0) wy = 0.0f;  // above row 0's centre both taps are row 0
  const int base = m.off[l];
  t[0] = base + y0i * w + x0i;
  t[1] = base + y0i * w + x1i;
  t[2] = base + y1i * w + x0i;
  t[3] = base + y1i * w + x1i;
}

__device__ __forceinline__ float3 texel(const float* atlas, int t) {
  return make_float3(__ldg(atlas + 3 * t), __ldg(atlas + 3 * t + 1),
                     __ldg(atlas + 3 * t + 2));
}

__device__ __forceinline__ float3 bilinear_value(const float* atlas,
                                                 const int (&t)[4], float wx,
                                                 float wy) {
  const float3 c00 = texel(atlas, t[0]), c01 = texel(atlas, t[1]);
  const float3 c10 = texel(atlas, t[2]), c11 = texel(atlas, t[3]);
  const float3 top = make_float3(c00.x + (c01.x - c00.x) * wx,
                                 c00.y + (c01.y - c00.y) * wx,
                                 c00.z + (c01.z - c00.z) * wx);
  const float3 bot = make_float3(c10.x + (c11.x - c10.x) * wx,
                                 c10.y + (c11.y - c10.y) * wx,
                                 c10.z + (c11.z - c10.z) * wx);
  return make_float3(top.x + (bot.x - top.x) * wy,
                     top.y + (bot.y - top.y) * wy,
                     top.z + (bot.z - top.z) * wy);
}

__global__ void __launch_bounds__(kThreads)
    sky_forward(SkyParams p, float* color) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const float* o = p.outputs + static_cast<size_t>(i) * p.n_out;
  const Lookup L = lookup(p, o);
  int t[4];
  float wx, wy;
  bilinear(p.mips, L.l0, L.u, L.v, t, wx, wy);
  float3 s = bilinear_value(p.atlas, t, wx, wy);
  if (p.mips.n > 1) {
    bilinear(p.mips, L.l1, L.u, L.v, t, wx, wy);
    const float3 b = bilinear_value(p.atlas, t, wx, wy);
    s = make_float3(s.x + (b.x - s.x) * L.frac, s.y + (b.y - s.y) * L.frac,
                    s.z + (b.z - s.z) * L.frac);
  }
  color[3 * i] = o[0] + s.x * o[3] * L.w_mis;
  color[3 * i + 1] = o[1] + s.y * o[4] * L.w_mis;
  color[3 * i + 2] = o[2] + s.z * o[5] * L.w_mis;
}

// Writes the four taps of a bilinear lookup from slot j of the block's
// staging area: texels t (or -1 where the ray never reached the sky) and
// their shares of the lookup's cotangent ga, top + (bot - top) wy with
// top = c00 + (c01 - c00) wx, as autograd takes them.
__device__ __forceinline__ void put_taps(int* keys, float* wts, int j,
                                         const int (&t)[4], float wx, float wy,
                                         float3 ga, bool reached) {
  const float3 gtop = make_float3(ga.x - ga.x * wy, ga.y - ga.y * wy,
                                  ga.z - ga.z * wy);
  const float3 gbot = make_float3(ga.x * wy, ga.y * wy, ga.z * wy);
  const float3 g[4] = {gtop, gtop, gbot, gbot};
  const float share[4] = {1.0f - wx, wx, 1.0f - wx, wx};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    keys[j + c] = reached ? t[c] : -1;
    wts[3 * (j + c)] = g[c].x * share[c];
    wts[3 * (j + c) + 1] = g[c].y * share[c];
    wts[3 * (j + c) + 2] = g[c].z * share[c];
  }
}

// A ray's row of outputs in registers, by 16-byte loads (12 columns) or
// 8-byte loads (10).
__device__ __forceinline__ void load_row(const SkyParams& p, int i,
                                         float (&o)[12]) {
  if (p.n_out == 12) {
    const float4* r = reinterpret_cast<const float4*>(p.outputs) + 3 * i;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 v = __ldg(r + c);
      o[4 * c] = v.x;
      o[4 * c + 1] = v.y;
      o[4 * c + 2] = v.z;
      o[4 * c + 3] = v.w;
    }
  } else {
    const float2* r = reinterpret_cast<const float2*>(p.outputs) + 5 * i;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float2 v = __ldg(r + c);
      o[2 * c] = v.x;
      o[2 * c + 1] = v.y;
    }
    o[10] = o[11] = 0.0f;
  }
}

// The block's digit counts: each thread's kSortItems digits (kNoDigit is
// not counted) into its warp's row of h, one add by the first lane of each
// group of equal digits in a step (no atomics), then the warps' rows summed
// into column `tile` of hist (a row of n_tiles a digit).
__device__ __forceinline__ void block_histogram(
    const int (&digit)[kSortItems], int radix, int (*h)[kMaxRadix],
    int* hist, int n_tiles, int tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int d = lane; d < radix; d += 32) h[warp][d] = 0;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kSortItems; ++s) {
    const unsigned peers = __match_any_sync(kFull, digit[s]);
    if (digit[s] != kNoDigit && lane == __ffs(peers) - 1)
      h[warp][digit[s]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kThreads) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += h[w][d];
    hist[d * n_tiles + tile] = c;
  }
}

// The cotangents of one ray's lookup, as autograd takes them through
// `deferred_sky`: g = ct * w * matten reaches the blend a + (b - a) frac
// as g - g frac and g frac, then each mip's four taps (`put_taps`); the
// miss attenuation gets ct * w * sky and the accumulated roughness
// range * sum_c g_c (b_c - a_c) where the level is inside [0, n - 1].
// With keys null (no mip wants a cotangent) the taps are not written.
// The block's taps go to shared memory first, then out as 16-byte vectors:
// the block's 2,048 keys and 6,144 weights are contiguous in the output.
// With hist (the ordering's first pass, whose tile of 2,048 keys is this
// block's taps) the block also writes its keys' first-digit counts, as
// sky_radix_count would.
__global__ void __launch_bounds__(kThreads)
    sky_backward_taps(SkyParams p, const float* ct, float* d_out, int* keys,
                      float* wts, int* hist, int digit_bits, int n_texels) {
  __shared__ __align__(16) int s_keys[kThreads * kTaps];
  __shared__ __align__(16) float s_wts[kThreads * kTaps * 3];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool taps = keys != nullptr;  // the same for the whole grid
  if (i < p.n) {
    float o[12];
    load_row(p, i, o);
    const Lookup L = lookup(p, o);
    const float3 cw = make_float3(ct[3 * i] * L.w_mis,
                                  ct[3 * i + 1] * L.w_mis,
                                  ct[3 * i + 2] * L.w_mis);
    const float3 g = make_float3(cw.x * o[3], cw.y * o[4], cw.z * o[5]);
    const bool reached = o[3] != 0.0f || o[4] != 0.0f || o[5] != 0.0f;
    const int j0 = threadIdx.x * kTaps;
    int t[4];
    float wx, wy;
    bilinear(p.mips, L.l0, L.u, L.v, t, wx, wy);
    float3 s = bilinear_value(p.atlas, t, wx, wy);
    float3 ga = g;
    float d_rough = 0.0f;
    if (p.mips.n > 1) {
      int t1[4];
      float wx1, wy1;
      bilinear(p.mips, L.l1, L.u, L.v, t1, wx1, wy1);
      const float3 b = bilinear_value(p.atlas, t1, wx1, wy1);
      const float d_frac = g.x * (b.x - s.x) + g.y * (b.y - s.y) +
                           g.z * (b.z - s.z);
      if (L.level_moves) d_rough = d_frac * p.range;
      s = make_float3(s.x + (b.x - s.x) * L.frac, s.y + (b.y - s.y) * L.frac,
                      s.z + (b.z - s.z) * L.frac);
      ga = make_float3(g.x - g.x * L.frac, g.y - g.y * L.frac,
                       g.z - g.z * L.frac);
      if (taps) {
        put_taps(s_keys, s_wts, j0 + 4, t1, wx1, wy1,
                 make_float3(g.x * L.frac, g.y * L.frac, g.z * L.frac),
                 reached);
      }
    } else if (taps) {
      for (int c = 4; c < kTaps; ++c) {
        s_keys[j0 + c] = -1;
        s_wts[3 * (j0 + c)] = s_wts[3 * (j0 + c) + 1] =
            s_wts[3 * (j0 + c) + 2] = 0.0f;
      }
    }
    if (taps) put_taps(s_keys, s_wts, j0, t, wx, wy, ga, reached);
    reinterpret_cast<float4*>(d_out)[i] =
        make_float4(cw.x * s.x, cw.y * s.y, cw.z * s.z, d_rough);
  }
  if (!taps) return;
  __syncthreads();
  // the block's rays [r0, r0 + nr): 2 int4 of keys and 6 float4 of
  // weights a ray, copied out with neighbouring threads on neighbouring
  // vectors
  const int r0 = blockIdx.x * kThreads;
  const int nr = min(kThreads, p.n - r0);
  int4* k_out = reinterpret_cast<int4*>(keys + static_cast<size_t>(r0) * kTaps);
  float4* w_out =
      reinterpret_cast<float4*>(wts + static_cast<size_t>(r0) * kTaps * 3);
  const int4* k_in = reinterpret_cast<const int4*>(s_keys);
  const float4* w_in = reinterpret_cast<const float4*>(s_wts);
  for (int c = threadIdx.x; c < 2 * nr; c += kThreads) k_out[c] = k_in[c];
  for (int c = threadIdx.x; c < 6 * nr; c += kThreads) w_out[c] = w_in[c];
  if (hist == nullptr) return;
  __syncthreads();  // the weights are out: their staging area takes counts
  int(*h)[kMaxRadix] = reinterpret_cast<int(*)[kMaxRadix]>(s_wts);
  int digit[kSortItems];
#pragma unroll
  for (int s = 0; s < kSortItems; ++s) {
    const int slot = s * kThreads + threadIdx.x;
    const int k = s_keys[slot];
    digit[s] = slot < kTaps * nr && k >= 0 && k < n_texels
                   ? k & ((1 << digit_bits) - 1)
                   : kNoDigit;
  }
  block_histogram(digit, 1 << digit_bits, h, hist, gridDim.x, blockIdx.x);
}

// An exclusive scan of one int a thread across the block, in thread
// order; `total` gets the block's sum. Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_sums[w];
    if (w < warp) before += c;
    total += c;
  }
  __syncthreads();
  return before + x - v;
}

// One pass of the ordering: the digit (key >> shift) & (2^bits - 1) of the
// pass's keys. The first pass reads the taps' keys, drops those outside
// [0, n_texels) and numbers the rest by their tap index; a later pass reads
// the pass before's keys and tap indices, `*count` of them.
struct SortPass {
  const int* keys;
  const int* idx;    // null in the first pass: the index is the position
  const int* count;  // null in the first pass: m keys
  int m;             // the first pass's keys, and a bound on every pass's
  int n_texels;
  int shift, bits;
  int n_tiles;  // tiles of m keys: the length of a histogram row
};

__device__ __forceinline__ int pass_count(const SortPass& p) {
  return p.count == nullptr ? p.m : *p.count;
}

// The pass's key j (-1 past the n keys).
__device__ __forceinline__ int pass_key(const SortPass& p, int j, int n) {
  return j < n ? __ldg(p.keys + j) : -1;
}

// The digit of a key; kNoDigit past the keys, and in the first pass for a
// key outside [0, n_texels). A later pass reads only keys it moved.
__device__ __forceinline__ int pass_digit(const SortPass& p, int key,
                                          bool in) {
  if (!in || (p.idx == nullptr && (key < 0 || key >= p.n_texels)))
    return kNoDigit;
  return (key >> p.shift) & ((1 << p.bits) - 1);
}

// hist[d * n_tiles + tile]: the keys of digit d in the tile (2,048 keys a
// block), by `block_histogram`.
__global__ void __launch_bounds__(kThreads)
    sky_radix_count(SortPass p, int* hist) {
  __shared__ int h[kWarps][kMaxRadix];
  const int n = pass_count(p);
  const int base = blockIdx.x * kSortTile;
  int key[kSortItems], digit[kSortItems];
#pragma unroll
  for (int s = 0; s < kSortItems; ++s)
    key[s] = pass_key(p, base + s * kThreads + threadIdx.x, n);
#pragma unroll
  for (int s = 0; s < kSortItems; ++s)
    digit[s] = pass_digit(p, key[s], base + s * kThreads + threadIdx.x < n);
  block_histogram(digit, 1 << p.bits, h, hist, p.n_tiles, blockIdx.x);
}

// Per digit (one block each): the exclusive scan of its row of tile counts,
// in tile order, in place; totals[d] the digit's keys.
__global__ void __launch_bounds__(kThreads)
    sky_radix_scan(int* hist, int n_tiles, int* totals) {
  int* row = hist + static_cast<size_t>(blockIdx.x) * n_tiles;
  const int per = (n_tiles + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n_tiles);
  const int hi = min(lo + per, n_tiles);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += row[t];
  int total;
  int run = block_exclusive_scan(sum, total);
  for (int t = lo; t < hi; ++t) {
    const int c = row[t];
    row[t] = run;
    run += c;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// The stable scatter of one pass. Warp w of a block takes keys
// [base + 256 w, base + 256 (w + 1)) in eight 32-key steps; a key's rank
// among the equal digits before it in its warp is its lanes' match
// (__match_any_sync) below it plus the warp's earlier steps; the warps'
// counts are added in warp order, after the digits before it (totals, in
// digit order) and the tiles before it (the scanned histogram). So the
// keys leave in the order of a stable sort by digit. The block first puts
// its keys in that order in shared memory, then writes them out with
// neighbouring threads on neighbouring slots (a digit's keys of a tile are
// contiguous in the output). The first pass writes the number of keys it
// kept to *count_out.
__global__ void __launch_bounds__(kThreads)
    sky_radix_scatter(SortPass p, const int* hist, const int* totals,
                      int* keys_out, int* idx_out, int* count_out) {
  __shared__ int cnt[kWarps][kMaxRadix];
  __shared__ int tile_base[kMaxRadix];  // the digit's slot in the output,
                                        // less its first slot in the tile
  __shared__ int s_key[kSortTile], s_src[kSortTile];
  const int radix = 1 << p.bits;
  const int n = pass_count(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int total;
  const int before = block_exclusive_scan(
      static_cast<int>(threadIdx.x) < radix ? totals[threadIdx.x] : 0, total);
  if (static_cast<int>(threadIdx.x) < radix)
    tile_base[threadIdx.x] =
        before + hist[threadIdx.x * p.n_tiles + blockIdx.x];
  if (count_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *count_out = total;
  const int base = blockIdx.x * kSortTile;
  if (base >= n) return;  // the whole block
  for (int d = lane; d < radix; d += 32) cnt[warp][d] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1;
  const int first = base + warp * 32 * kSortItems;
  int key[kSortItems], src[kSortItems], digit[kSortItems], rank[kSortItems];
#pragma unroll
  for (int s = 0; s < kSortItems; ++s) {  // every load before the first use
    const int j = first + 32 * s + lane;
    key[s] = pass_key(p, j, n);
    src[s] = p.idx == nullptr ? j : j < n ? __ldg(p.idx + j) : 0;
  }
#pragma unroll
  for (int s = 0; s < kSortItems; ++s) {
    digit[s] = pass_digit(p, key[s], first + 32 * s + lane < n);
    const unsigned peers = __match_any_sync(kFull, digit[s]);
    const bool moves = digit[s] != kNoDigit;
    if (moves) rank[s] = cnt[warp][digit[s]] + __popc(peers & below);
    __syncwarp();
    if (moves && lane == __ffs(peers) - 1)
      cnt[warp][digit[s]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // the tile's keys of each digit, their first slot in the tile (digit
  // order), and each warp's first slot for the digit (warp order)
  const int d0 = threadIdx.x;
  int in_tile = 0;
  if (d0 < radix)
    for (int w = 0; w < kWarps; ++w) in_tile += cnt[w][d0];
  int kept;
  const int start = block_exclusive_scan(d0 < radix ? in_tile : 0, kept);
  if (d0 < radix) {
    int run = start;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w][d0];
      cnt[w][d0] = run;
      run += c;
    }
    tile_base[d0] -= start;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSortItems; ++s) {
    if (digit[s] == kNoDigit) continue;
    const int slot = cnt[warp][digit[s]] + rank[s];
    s_key[slot] = key[s];
    s_src[slot] = src[s];
  }
  __syncthreads();
  const int mask = (1 << p.bits) - 1;
  for (int slot = threadIdx.x; slot < kept; slot += kThreads) {
    const int k = s_key[slot];
    const int pos = tile_base[(k >> p.shift) & mask] + slot;
    keys_out[pos] = k;
    idx_out[pos] = s_src[slot];
  }
}

// One level of the per-texel sums over `*count` ordered keys: level 0
// reads the ordering (keys, tap indices into the taps' weights), a later
// level the carries of the level before (keys and their partial sums).
struct SumLevel {
  const int* keys;
  const int* idx;      // level 0: weights at vals[3 * idx[j]]; else null
  const float* vals;
  const int* count;
  int* carry_keys;     // two slots a tile: its first and its last run
  float* carry_vals;
  int* count_out;      // the carries' number, 0 when this level is the last
  float* out;          // [n_texels, 3], zeroed, or with `add` a sum to add to
  bool add;            // out[t] += the run's sum, where it is written
};

// A lane's kSumItems consecutive keys and their weights, by 16-byte loads
// where the lane's keys are all below `end` (every weight load issued
// before the first is used); key -1 past the end.
__device__ __forceinline__ void load_items(const SumLevel& p, int j0, int end,
                                           int (&k)[kSumItems],
                                           float (&v)[kSumItems][3]) {
  if (j0 + kSumItems <= end) {
    const int4* kv = reinterpret_cast<const int4*>(p.keys + j0);
#pragma unroll
    for (int c = 0; c < kSumItems / 4; ++c) {
      const int4 q = __ldg(kv + c);
      k[4 * c] = q.x;
      k[4 * c + 1] = q.y;
      k[4 * c + 2] = q.z;
      k[4 * c + 3] = q.w;
    }
    if (p.idx != nullptr) {
      int src[kSumItems];
      const int4* iv = reinterpret_cast<const int4*>(p.idx + j0);
#pragma unroll
      for (int c = 0; c < kSumItems / 4; ++c) {
        const int4 q = __ldg(iv + c);
        src[4 * c] = q.x;
        src[4 * c + 1] = q.y;
        src[4 * c + 2] = q.z;
        src[4 * c + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < kSumItems; ++i) {
        const float* w = p.vals + 3 * static_cast<size_t>(src[i]);
        v[i][0] = __ldg(w);
        v[i][1] = __ldg(w + 1);
        v[i][2] = __ldg(w + 2);
      }
    } else {
      const float4* vv =
          reinterpret_cast<const float4*>(p.vals + 3 * static_cast<size_t>(j0));
#pragma unroll
      for (int c = 0; c < 3 * kSumItems / 4; ++c) {
        const float4 q = __ldg(vv + c);
        v[(4 * c) / 3][(4 * c) % 3] = q.x;
        v[(4 * c + 1) / 3][(4 * c + 1) % 3] = q.y;
        v[(4 * c + 2) / 3][(4 * c + 2) % 3] = q.z;
        v[(4 * c + 3) / 3][(4 * c + 3) % 3] = q.w;
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kSumItems; ++i) {
    const int j = j0 + i;
    k[i] = -1;
    v[i][0] = v[i][1] = v[i][2] = 0.0f;
    if (j < end) {
      k[i] = __ldg(p.keys + j);
      const size_t q = p.idx != nullptr
                           ? static_cast<size_t>(__ldg(p.idx + j))
                           : static_cast<size_t>(j);
      v[i][0] = __ldg(p.vals + 3 * q);
      v[i][1] = __ldg(p.vals + 3 * q + 1);
      v[i][2] = __ldg(p.vals + 3 * q + 2);
    }
  }
}

// A warp a tile of kSumTile keys, lane l its keys [16 l, 16 l + 16). A key
// is a head where it differs from the key before it (the tile's first key
// always). The lane adds the keys since its last head one after another
// (its partial, the earlier sum first); the lanes take an inclusive
// segmented scan of (a head in the lane, its partial), Hillis-Steele over
// 1, 2, 4, 8, 16 lanes, the lower lanes' sum added first, so lane l - 1's
// result is the partial of the run that enters lane l. The lane then
// walks its keys again from that partial; at a run's last key it holds the
// run's sum: a run inside the tile is written to out, the tile's first and
// last runs (a run that may cross into a neighbour) go to the tile's two
// carry slots, (key, partial), the last slot (key, 0) where one run fills
// the tile. With one tile left every run is whole and written.
__global__ void __launch_bounds__(kThreads) sky_reduce_texels(SumLevel p) {
  const int n = *p.count;
  const int tiles = (n + kSumTile - 1) / kSumTile;
  const bool last = tiles <= 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.count_out = last ? 0 : 2 * tiles;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= tiles) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int base = tile * kSumTile;
  const int end = min(base + kSumTile, n);
  const int k_first = __ldg(p.keys + base), k_last = __ldg(p.keys + end - 1);
  int k[kSumItems];
  float v[kSumItems][3];
  load_items(p, base + lane * kSumItems, end, k, v);
  const int k_before = __shfl_up_sync(kFull, k[kSumItems - 1], 1);
  const int k_after = __shfl_down_sync(kFull, k[0], 1);
  bool head[kSumItems];
  bool any = false;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
#pragma unroll
  for (int i = 0; i < kSumItems; ++i) {
    head[i] = i == 0 ? lane == 0 || k_before != k[0]
                     : k[i > 0 ? i - 1 : 0] != k[i];
    if (i == 0 || head[i]) {
      ax = v[i][0];
      ay = v[i][1];
      az = v[i][2];
    } else {
      ax = ax + v[i][0];
      ay = ay + v[i][1];
      az = az + v[i][2];
    }
    any = any || head[i];
  }
  bool f = any;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ux = __shfl_up_sync(kFull, ax, d);
    const float uy = __shfl_up_sync(kFull, ay, d);
    const float uz = __shfl_up_sync(kFull, az, d);
    const int uf = __shfl_up_sync(kFull, static_cast<int>(f), d);
    if (lane >= d) {
      if (!f) {
        ax = ux + ax;
        ay = uy + ay;
        az = uz + az;
      }
      f = f || uf != 0;
    }
  }
  float rx = __shfl_up_sync(kFull, ax, 1);
  float ry = __shfl_up_sync(kFull, ay, 1);
  float rz = __shfl_up_sync(kFull, az, 1);
#pragma unroll
  for (int i = 0; i < kSumItems; ++i) {
    if (head[i]) {
      rx = v[i][0];
      ry = v[i][1];
      rz = v[i][2];
    } else {
      rx = rx + v[i][0];
      ry = ry + v[i][1];
      rz = rz + v[i][2];
    }
    const int next = i + 1 < kSumItems ? k[i + 1 < kSumItems ? i + 1 : i]
                     : lane < 31 ? k_after : -1;
    if (k[i] < 0 || next == k[i]) continue;
    if (last || (k[i] != k_first && k[i] != k_last)) {
      float* o = p.out + 3 * static_cast<size_t>(k[i]);
      if (p.add) {
        rx = o[0] + rx;
        ry = o[1] + ry;
        rz = o[2] + rz;
      }
      o[0] = rx;
      o[1] = ry;
      o[2] = rz;
    } else {
      const int slot = 2 * tile + (k[i] == k_first ? 0 : 1);
      p.carry_keys[slot] = k[i];
      p.carry_vals[3 * slot] = rx;
      p.carry_vals[3 * slot + 1] = ry;
      p.carry_vals[3 * slot + 2] = rz;
    }
  }
  if (!last && k_first == k_last && lane == 0) {
    p.carry_keys[2 * tile + 1] = k_first;
    p.carry_vals[3 * (2 * tile + 1)] = 0.0f;
    p.carry_vals[3 * (2 * tile + 1) + 1] = 0.0f;
    p.carry_vals[3 * (2 * tile + 1) + 2] = 0.0f;
  }
}

// The mip layout from the host: [n, h_0, w_0, h_1, w_1, ...].
bool make_params(SkyParams& p, const float* outputs, const float* atlas,
                 const float* pdf, const int* mips, int n, int n_out,
                 int pdf_h, int pdf_w, int bias, int nee, float base_level,
                 float range) {
  if (mips == nullptr || mips[0] < 1 || mips[0] > kMaxMips) return false;
  if (n_out != 10 && n_out != 12) return false;
  if (nee && (pdf == nullptr || n_out != 12 || pdf_h <= 0 || pdf_w <= 0))
    return false;
  p.outputs = outputs;
  p.atlas = atlas;
  p.pdf = pdf;
  p.n = n;
  p.n_out = n_out;
  p.pdf_h = pdf_h;
  p.pdf_w = pdf_w;
  p.bias = bias != 0;
  p.nee = nee != 0;
  p.base_level = base_level;
  p.range = range;
  p.mips.n = mips[0];
  long long off = 0;
  for (int l = 0; l < mips[0]; ++l) {
    p.mips.h[l] = mips[1 + 2 * l];
    p.mips.w[l] = mips[2 + 2 * l];
    if (p.mips.h[l] <= 0 || p.mips.w[l] <= 0) return false;
    p.mips.off[l] = static_cast<int>(off);
    off += static_cast<long long>(p.mips.h[l]) * p.mips.w[l];
  }
  return off < (1ll << 31);
}

}  // namespace

extern "C" int halogen_sky_forward(const float* outputs, const float* atlas,
                                   const float* pdf, const int* mips,
                                   float* color, int n, int n_out, int pdf_h,
                                   int pdf_w, int bias, int nee,
                                   float base_level, float range,
                                   void* stream) {
  SkyParams p;
  if (!make_params(p, outputs, atlas, pdf, mips, n, n_out, pdf_h, pdf_w,
                   bias, nee, base_level, range))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  sky_forward<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(p, color);
  return static_cast<int>(cudaGetLastError());
}

// With hist (and keys), also the ordering's first-pass digit counts of
// the taps (`digit_bits` bits of the keys in [0, n_texels)), as
// halogen_sky_order's hist, which it then need not count.
extern "C" int halogen_sky_backward(const float* outputs, const float* atlas,
                                    const float* pdf, const int* mips,
                                    const float* ct, float* d_out, int* keys,
                                    float* wts, int* hist, int n, int n_out,
                                    int pdf_h, int pdf_w, int bias, int nee,
                                    int digit_bits, int n_texels,
                                    float base_level, float range,
                                    void* stream) {
  SkyParams p;
  if (!make_params(p, outputs, atlas, pdf, mips, n, n_out, pdf_h, pdf_w,
                   bias, nee, base_level, range))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hist != nullptr &&
      (keys == nullptr || digit_bits < 1 || digit_bits > kMaxDigitBits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  sky_backward_taps<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      p, ct, d_out, keys, wts, hist, digit_bits, n_texels);
  return static_cast<int>(cudaGetLastError());
}

// The ordering: `passes` stable passes of `digit_bits` bits over the m
// keys, the last into keys_out and idx_out (tap indices), the others into
// keys_tmp and idx_tmp; hist holds 2^digit_bits rows of ceil(m / 2048)
// tile counts (with `counted`, the first pass's are there already:
// halogen_sky_backward's), totals 2^digit_bits ints; *count gets the
// number of keys in [0, n_texels), the length of the order.
extern "C" int halogen_sky_order(const int* keys, int* keys_out,
                                 int* idx_out, int* keys_tmp, int* idx_tmp,
                                 int* hist, int* totals, int* count, int m,
                                 int n_texels, int passes, int digit_bits,
                                 int counted, void* stream) {
  if (m <= 0 || n_texels <= 0 || passes < 1 || digit_bits < 1 ||
      digit_bits > kMaxDigitBits || passes * digit_bits > 31 ||
      (n_texels - 1) >> (passes * digit_bits) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SortPass p;
  p.keys = keys;
  p.idx = nullptr;
  p.count = nullptr;
  p.m = m;
  p.n_texels = n_texels;
  p.bits = digit_bits;
  p.n_tiles = (m + kSortTile - 1) / kSortTile;
  const int radix = 1 << digit_bits;
  for (int pass = 0; pass < passes; ++pass) {
    const bool to_out = (passes - 1 - pass) % 2 == 0;
    int* k_out = to_out ? keys_out : keys_tmp;
    int* i_out = to_out ? idx_out : idx_tmp;
    p.shift = pass * digit_bits;
    if (pass > 0 || !counted)
      sky_radix_count<<<p.n_tiles, kThreads, 0, st>>>(p, hist);
    sky_radix_scan<<<radix, kThreads, 0, st>>>(hist, p.n_tiles, totals);
    sky_radix_scatter<<<p.n_tiles, kThreads, 0, st>>>(
        p, hist, totals, k_out, i_out, pass == 0 ? count : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    p.keys = k_out;
    p.idx = i_out;
    p.count = count;
  }
  return static_cast<int>(cudaSuccess);
}

// The number of launches of the sums over m ordered keys: the first level
// and the carries' levels (`kernels/sky.py` _sum_plan).
static int sum_levels(int m) {
  int levels = 1;
  for (long long ub = m; ub > kSumTile; ++levels)
    ub = 2 * ((ub + kSumTile - 1) / kSumTile);
  return levels;
}

// out[t] = the sum of wts[idx[j]] over the run of texel t in the ordered
// keys, *count of them (out is zeroed first); carry_keys / carry_vals hold
// two buffers
// of `cap` slots (ping-pong between levels; cap a multiple of 4, so that
// both are 16-byte aligned), counts one int a level. With `add`, out is
// not zeroed and each texel's run is added to it, out[t] = out[t] + run:
// a texel is written at one level only, once a call, so the texels
// without a tap keep their value and the sums keep their order (a chunk
// node's groups add into one gradient buffer, kernels/sky.py
// `sky_backward_groups`).
extern "C" int halogen_sky_sum(const int* keys, const int* idx,
                               const float* wts, const int* count,
                               int* carry_keys, float* carry_vals,
                               int* counts, float* out, int m, int cap,
                               int n_levels, int n_texels, int add,
                               void* stream) {
  if (m <= 0 || n_texels <= 0 || n_levels != sum_levels(m) ||
      cap % 4 != 0 || cap < 2 * ((m + kSumTile - 1) / kSumTile))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!add) {
    const cudaError_t zeroed = cudaMemsetAsync(
        out, 0, static_cast<size_t>(n_texels) * 3 * sizeof(float), st);
    if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  }
  SumLevel p;
  p.add = add != 0;
  p.keys = keys;
  p.idx = idx;
  p.vals = wts;
  p.count = count;
  p.out = out;
  long long ub = m;
  for (int level = 0; level < n_levels; ++level) {
    p.carry_keys = carry_keys + static_cast<size_t>(level % 2) * cap;
    p.carry_vals = carry_vals + static_cast<size_t>(level % 2) * cap * 3;
    p.count_out = counts + level;
    const long long tiles = (ub + kSumTile - 1) / kSumTile;
    sky_reduce_texels<<<static_cast<int>((tiles + kWarps - 1) / kWarps),
                        kThreads, 0, st>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    p.keys = p.carry_keys;
    p.idx = nullptr;
    p.vals = p.carry_vals;
    p.count = p.count_out;
    ub = 2 * tiles;
  }
  return static_cast<int>(cudaSuccess);
}
