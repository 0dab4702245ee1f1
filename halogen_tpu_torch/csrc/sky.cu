// The sky at the miss for NVIDIA Hopper (sm_90a): the forward kernel and
// its backward, which sums every texel's cotangent in a fixed order.
//
// Replaces the sky pass after the fused megakernel, which the JAX package
// leaves to XLA (`halogen_tpu/integrator/trace.py:460-482`,
// `halogen_tpu/kernels/megakernel.py:1868-1900` with
// `scene/envmap.py::sample_env_packed` and its vjp), and whose plain
// PyTorch version (`integrator/trace.py::deferred_sky`) takes ~150 eager
// launches a group. Three kernels:
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
//     and its share of ct * w * matten;
//   sky_scatter_sum: the per-texel sums of those taps (and of the adjoint's
//     env-NEE records): the wrapper orders the taps by texel with a stable
//     sort, which keeps each texel's taps in ray order, and one warp per
//     texel sums its run: lane l takes taps l, l + 32, ... in order, then
//     the lanes add in a fixed tree. No float atomics: two calls give the
//     same bits.
// The taps follow the footprint-packed lookup the plain version
// differentiates (`pack_footprint`): above the first row's centre the
// weight of the second row is 0, and the second row is min(y0 + 1, H - 1).
//
// What bounds it on this card: memory and latency. The forward reads 40 or
// 48 bytes of a ray's outputs and eight texels (cached: the pyramid of an
// envmap is small beside L2) and writes 12 bytes; the backward writes a
// ray's eight taps (key and three weights, 128 bytes), which the sort
// reads and writes again, and the sum reads each tap once. One thread a
// ray, 256 threads a block; the sum's warps read their runs contiguously.
//
// Build with -fmad=false and without fast math, as megakernel.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMips = 16;
constexpr int kTaps = 8;
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

__device__ __forceinline__ Lookup lookup(const SkyParams& p, int i) {
  const float* o = p.outputs + static_cast<size_t>(i) * p.n_out;
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
  const Lookup L = lookup(p, i);
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

// Writes the four taps of a bilinear lookup from slot j: texels t (or -1
// where the ray never reached the sky) and their shares of the lookup's
// cotangent ga, top + (bot - top) wy with top = c00 + (c01 - c00) wx, as
// autograd takes them.
__device__ __forceinline__ void put_taps(int* keys, float* wts, size_t j,
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

// The cotangents of one ray's lookup, as autograd takes them through
// `deferred_sky`: g = ct * w * matten reaches the blend a + (b - a) frac
// as g - g frac and g frac, then each mip's four taps (`put_taps`); the
// miss attenuation gets ct * w * sky and the accumulated roughness
// range * sum_c g_c (b_c - a_c) where the level is inside [0, n - 1].
// With keys null (no mip wants a cotangent) the taps are not written.
__global__ void __launch_bounds__(kThreads)
    sky_backward_taps(SkyParams p, const float* ct, float* d_out, int* keys,
                      float* wts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const float* o = p.outputs + static_cast<size_t>(i) * p.n_out;
  const Lookup L = lookup(p, i);
  const float3 cw = make_float3(ct[3 * i] * L.w_mis, ct[3 * i + 1] * L.w_mis,
                                ct[3 * i + 2] * L.w_mis);
  const float3 g = make_float3(cw.x * o[3], cw.y * o[4], cw.z * o[5]);
  const bool reached = o[3] != 0.0f || o[4] != 0.0f || o[5] != 0.0f;
  const size_t j0 = static_cast<size_t>(i) * kTaps;
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
    if (keys != nullptr) {
      put_taps(keys, wts, j0 + 4, t1, wx1, wy1,
               make_float3(g.x * L.frac, g.y * L.frac, g.z * L.frac),
               reached);
    }
  } else if (keys != nullptr) {
    for (int c = 4; c < kTaps; ++c) keys[j0 + c] = -1;
  }
  if (keys != nullptr) put_taps(keys, wts, j0, t, wx, wy, ga, reached);
  d_out[4 * i] = cw.x * s.x;
  d_out[4 * i + 1] = cw.y * s.y;
  d_out[4 * i + 2] = cw.z * s.z;
  d_out[4 * i + 3] = d_rough;
}

// First j in [0, m) with keys[j] >= key (keys ascending).
__device__ __forceinline__ int lower_bound(const int* keys, int m, int key) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// out[t] = sum of wts[perm[j]] over the run of texel t in the sorted keys,
// one warp a texel, in a fixed order.
__global__ void __launch_bounds__(kThreads)
    sky_scatter_sum(const int* keys, const long long* perm, const float* wts,
                    int m, int n_texels, float* out) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= n_texels) return;  // whole warps leave together
  const int lo = lower_bound(keys, m, t);
  const int hi = lower_bound(keys, m, t + 1);
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int j = lo + lane; j < hi; j += 32) {
    const long long q = __ldg(perm + j);
    sx += __ldg(wts + 3 * q);
    sy += __ldg(wts + 3 * q + 1);
    sz += __ldg(wts + 3 * q + 2);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    sx += __shfl_down_sync(kFull, sx, s);
    sy += __shfl_down_sync(kFull, sy, s);
    sz += __shfl_down_sync(kFull, sz, s);
  }
  if (lane == 0) {
    out[3 * t] = sx;
    out[3 * t + 1] = sy;
    out[3 * t + 2] = sz;
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

extern "C" int halogen_sky_backward(const float* outputs, const float* atlas,
                                    const float* pdf, const int* mips,
                                    const float* ct, float* d_out, int* keys,
                                    float* wts, int n, int n_out, int pdf_h,
                                    int pdf_w, int bias, int nee,
                                    float base_level, float range,
                                    void* stream) {
  SkyParams p;
  if (!make_params(p, outputs, atlas, pdf, mips, n, n_out, pdf_h, pdf_w,
                   bias, nee, base_level, range))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  sky_backward_taps<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p, ct, d_out, keys,
                                                           wts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int halogen_sky_scatter(const int* keys, const long long* perm,
                                   const float* wts, float* out, int m,
                                   int n_texels, void* stream) {
  if (n_texels <= 0) return static_cast<int>(cudaSuccess);
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = 32ll * n_texels;
  sky_scatter_sum<<<static_cast<int>((threads + kThreads - 1) / kThreads),
                    kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, perm, wts, m, n_texels, out);
  return static_cast<int>(cudaGetLastError());
}
