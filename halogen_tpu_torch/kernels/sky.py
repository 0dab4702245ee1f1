"""The sky at the miss as a pair of CUDA kernels: the forward lookup and a
deterministic backward (`csrc/sky.cu`).

After the fused megakernel each ray's color gets the sky at its miss: a
trilinear lookup of the envmap's mip pyramid at the recorded direction
and mip-bias level, times the miss attenuation and, with env NEE, the
balance-heuristic weight (`integrator.trace.deferred_sky`, the JAX
package's XLA sky pass `trace.py:460-482`). On a CUDA device
`sky_color` runs it as one launch a group (`SkyPass`, a
`torch.autograd.Function`); its backward is the sky backward kernel:
per ray the cotangents of the miss attenuation and of the accumulated
roughness, which the adjoint kernel takes (`kernels/adjoint.py`), and the
ray's eight taps of the lookup, which `scatter_texels` sums into each
texel of each mip in a fixed order: two calls give the same bits, where
autograd through the gathers would scatter with float atomics. The
adjoint's env-NEE records are summed into the finest mip the same way.

`scatter_texels` has two stages on the card, each its kernels: the
ordering (`order_texels` gives it), a stable LSD radix sort of the keys
by texel over the bits the atlas needs (`order_plan`), which drops the
keys outside [0, n_texels) and keeps each texel's run in tap order; and
the sums, a reduce-by-key over fixed tiles of the ordered taps whose
runs that cross a tile go to carry slots, added in tile order by the
next level. One int32 workspace holds both stages' buffers. The sums
write a new [n_texels, 3] buffer, or add each texel's run into a given
one (`scatter_texels(..., out=)`): the chunk node's backward,
`sky_backward_groups`, adds its groups' sums into one gradient buffer,
in the order in which autograd adds those of one `SkyPass` a group.

On the CPU, and under `Fused.OFF`, the plain version runs:
`deferred_sky` with torch autograd. `sky_taps_reference` is the plain
PyTorch version of the backward kernel, tap for tap; `torch.sort(stable=
True)` that of the ordering; `reduce_texels_model` that of the sums, tile
for tile and addition for addition; `scatter_texels` on the CPU is
`index_add_` in index order. A CUDA launch that fails raises; there is
no fallback. `FORWARD_LAUNCHES`, `BACKWARD_LAUNCHES`, `ORDER_LAUNCHES`
and `SCATTER_LAUNCHES` count the launches, `ATLAS_BUILDS` the copies of
the mips into an atlas (one a `SkyPass`, kept for its backward; one a
chunk node, kept for its backward where a gradient follows and dropped
at its end; one a plain taps call).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from halogen_tpu_torch.config import RenderSettings
from halogen_tpu_torch.core.types import SceneData
from halogen_tpu_torch.integrator.trace import _use_nee, deferred_sky
from halogen_tpu_torch.scene.envmap import dir_to_equirect_uv, env_pdf
from halogen_tpu_torch.utils.profiling import annotate

TAPS = 8  # four bilinear taps in each of two mips
MAX_MIPS = 16  # csrc/sky.cu kMaxMips
SORT_TILE = 2048  # csrc/sky.cu kSortTile: keys a block in a sort pass
MAX_DIGIT_BITS = 8  # kMaxDigitBits: bits of a sort pass
SUM_TILE = 512  # kSumTile: ordered taps a warp in the sums
LANES = 32

FORWARD_LAUNCHES = 0  # sky forward launches since the count was set to 0
BACKWARD_LAUNCHES = 0  # sky backward (taps) launches
ORDER_LAUNCHES = 0  # orderings by texel (the radix passes of one call)
SCATTER_LAUNCHES = 0  # per-texel sums (the levels of one call)
ATLAS_BUILDS = 0  # copies of the mips into an atlas (`atlas`)


def uses_sky(scene: SceneData, settings: RenderSettings) -> bool:
    """Whether the color gets a sky at the miss."""
    return settings.use_envmap and bool(scene.env_mips)


def atlas(env_mips) -> torch.Tensor:
    """Every mip's texels, finest first: [sum H_l W_l, 3] float32, a new
    copy (counted in `ATLAS_BUILDS`)."""
    global ATLAS_BUILDS
    with annotate("halogen.wrap.sky_atlas"):
        tex = torch.cat([m.reshape(-1, 3) for m in env_mips]).to(
            torch.float32).contiguous()
    ATLAS_BUILDS += 1
    return tex


def split_mips(flat: torch.Tensor, env_mips) -> tuple:
    """[sum H_l W_l, 3] -> one [H_l, W_l, 3] view per mip."""
    shapes = [(int(m.shape[0]), int(m.shape[1])) for m in env_mips]
    parts = torch.split(flat, [h * w for h, w in shapes])
    return tuple(p.view(h, w, 3) for p, (h, w) in zip(parts, shapes))


def _lib():
    from halogen_tpu_torch.kernels import megakernel as mk

    return mk.load_library("sky")


def _check(t: torch.Tensor, name: str, shape, dtype, dev) -> None:
    if (t.shape != shape or t.dtype != dtype or not t.is_contiguous()
            or t.device != dev):
        raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} "
                         f"on {dev}")


def _kernel_args(scene: SceneData, settings: RenderSettings,
                 outputs: torch.Tensor, env_mips):
    """Check the launch; returns (atlas, pdf, host mip layout, the ints after
    the ray count, the floats)."""
    n, n_out = outputs.shape
    dev = outputs.device
    nee = _use_nee(scene, settings)
    if n_out != (12 if nee else 10):
        raise ValueError(f"the sky pass takes [N, {12 if nee else 10}] "
                         "outputs")
    _check(outputs, "outputs", (n, n_out), torch.float32, dev)
    if outputs.data_ptr() % (16 if nee else 8):
        raise ValueError("the sky kernels read a ray's outputs as 16-byte "
                         "(12 columns) or 8-byte (10) vectors: align them")
    if not 1 <= len(env_mips) <= MAX_MIPS:
        raise ValueError(f"the sky kernels take 1 to {MAX_MIPS} mips")
    tex = atlas(env_mips)
    if tex.device != dev:
        raise ValueError(f"the envmap is on {tex.device}, the rays on {dev}")
    layout = [len(env_mips)]
    for m in env_mips:
        layout += [int(m.shape[0]), int(m.shape[1])]
    layout = (ctypes.c_int * len(layout))(*layout)
    pdf, pdf_h, pdf_w = None, 0, 0
    if nee:
        pdf = scene.env_cdf.pdf.to(torch.float32).contiguous()
        pdf_h, pdf_w = pdf.shape
        if pdf.device != dev:
            raise ValueError(f"the env pdf is on {pdf.device}, not {dev}")
    ints = (n, n_out, pdf_h, pdf_w, int(settings.mip_importance_bias),
            int(nee))
    floats = (float(settings.env_mip_level),
              float(settings.mip_importance_range))
    return tex, pdf, layout, ints, floats


def sky_forward(scene: SceneData, settings: RenderSettings,
                outputs: torch.Tensor, env_mips=None,
                launch_args=None) -> torch.Tensor:
    """[N, 3] radiance: the path color plus the sky at the miss. The kernel
    on a CUDA device, `deferred_sky` on the CPU. `env_mips` defaults to the
    scene's; `launch_args`, `_kernel_args` of the same call where the
    caller has them (`SkyPass` keeps them for its backward)."""
    global FORWARD_LAUNCHES
    env_mips = scene.env_mips if env_mips is None else tuple(env_mips)
    if not uses_sky(scene, settings):
        return outputs[:, 0:3]
    if outputs.device.type == "cpu":
        return deferred_sky(scene, settings, outputs)
    if outputs.device.type != "cuda":
        raise ValueError(f"no sky kernel for device {outputs.device}")
    tex, pdf, layout, ints, floats = launch_args or _kernel_args(
        scene, settings, outputs, env_mips)
    dev = outputs.device
    color = torch.empty((outputs.shape[0], 3), dtype=torch.float32,
                        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().halogen_sky_forward(
            outputs.data_ptr(), tex.data_ptr(),
            None if pdf is None else pdf.data_ptr(), ctypes.addressof(layout),
            color.data_ptr(), *ints, *floats, stream)
    if err != 0:
        raise RuntimeError(f"sky forward launch failed: CUDA error {err}")
    FORWARD_LAUNCHES += 1
    return color


def sky_taps_reference(scene: SceneData, settings: RenderSettings,
                       outputs: torch.Tensor, ct: torch.Tensor, env_mips=None):
    """Plain PyTorch version of the backward kernel's first step, tap for
    tap: (d_out [N, 4]: the cotangents of the miss attenuation rgb and of
    the accumulated roughness; keys [N * 8] int32, the atlas texel of each
    tap, -1 for a ray that never reached the sky; weights [N * 8, 3])."""
    env_mips = scene.env_mips if env_mips is None else tuple(env_mips)
    n = outputs.shape[0]
    dev = outputs.device
    n_mips = len(env_mips)
    hs = [int(m.shape[0]) for m in env_mips]
    ws = [int(m.shape[1]) for m in env_mips]
    offs = [sum(h * w for h, w in zip(hs[:l], ws[:l])) for l in range(n_mips)]
    tex = atlas(env_mips)
    matten, rough = outputs[:, 3:6], outputs[:, 6]
    u, v = dir_to_equirect_uv(outputs[:, 7:10])
    if settings.mip_importance_bias:
        raw = settings.env_mip_level + rough * settings.mip_importance_range
    else:
        raw = torch.full_like(rough, float(settings.env_mip_level))
    level = torch.clamp(raw, 0.0, float(n_mips - 1))
    moves = ((raw >= 0.0) & (raw <= float(n_mips - 1))
             & bool(settings.mip_importance_bias) & (n_mips > 1))
    if n_mips == 1:
        l0 = torch.zeros((n,), dtype=torch.int64, device=dev)
    else:
        l0 = torch.clamp(torch.floor(level).to(torch.int64), 0, n_mips - 2)
    l1 = torch.clamp_max(l0 + 1, n_mips - 1)
    frac = (level - l0.to(torch.float32))[:, None]
    w_mis = torch.ones((n,), device=dev)
    if _use_nee(scene, settings):
        pe = env_pdf(scene.env_cdf, outputs[:, 7:10])
        w_mis = torch.where(outputs[:, 11] > 0.5, outputs[:, 10]
                            / torch.clamp_min(outputs[:, 10] + pe, 1e-12),
                            1.0)
    cw = ct * w_mis[:, None]
    g = cw * matten
    reached = (matten != 0).any(dim=1)
    h_t = torch.tensor(hs, device=dev)
    w_t = torch.tensor(ws, device=dev)
    off_t = torch.tensor(offs, device=dev)

    def taps(li):
        h, w, off = h_t[li], w_t[li], off_t[li]
        fx = u * w.to(torch.float32) - 0.5
        fy = v * h.to(torch.float32) - 0.5
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]
        x0i = torch.remainder(x0.to(torch.int64), w)
        x1i = torch.remainder(x0i + 1, w)
        y0u = y0.to(torch.int64)
        y0i = torch.clamp(torch.minimum(y0u, h - 1), min=0)
        y1i = torch.minimum(y0i + 1, h - 1)
        wy = torch.where((y0u < 0)[:, None], 0.0, wy)
        t = torch.stack([off + y0i * w + x0i, off + y0i * w + x1i,
                         off + y1i * w + x0i, off + y1i * w + x1i], dim=1)
        c = tex[t]  # [N, 4, 3]
        top = c[:, 0] + (c[:, 1] - c[:, 0]) * wx
        bot = c[:, 2] + (c[:, 3] - c[:, 2]) * wx
        return t, wx, wy, top + (bot - top) * wy

    def shares(ga, wx, wy):
        gtop, gbot = ga - ga * wy, ga * wy
        return torch.stack([gtop * (1.0 - wx), gtop * wx, gbot * (1.0 - wx),
                            gbot * wx], dim=1)  # [N, 4, 3]

    t0, wx0, wy0, a = taps(l0)
    keys = [t0]
    d_rough = torch.zeros((n,), device=dev)
    if n_mips > 1:
        t1, wx1, wy1, b = taps(l1)
        d_frac = (g * (b - a)).sum(dim=1)
        d_rough = torch.where(moves, d_frac * settings.mip_importance_range,
                              0.0)
        sky = a + (b - a) * frac
        wts = [shares(g - g * frac, wx0, wy0), shares(g * frac, wx1, wy1)]
        keys.append(t1)
    else:
        sky = a
        wts = [shares(g, wx0, wy0), torch.zeros((n, 4, 3), device=dev)]
        keys.append(torch.full_like(t0, -1))
    keys = torch.cat(keys, dim=1)
    keys = torch.where(reached[:, None], keys, -1).to(torch.int32)
    d_out = torch.cat([cw * sky, d_rough[:, None]], dim=1)
    return d_out, keys.reshape(-1), torch.cat(wts, dim=1).reshape(-1, 3)


def sky_backward(scene: SceneData, settings: RenderSettings,
                 outputs: torch.Tensor, ct: torch.Tensor, env_mips=None,
                 taps: bool = True, launch_args=None, order=None,
                 stream=None, out=None):
    """The backward's first step: (d_out [N, 4], keys [N * 8], weights
    [N * 8, 3]) as `sky_taps_reference` gives them; the kernel on a CUDA
    device, the plain version on the CPU. Without `taps` (no mip wants a
    cotangent) the kernel writes d_out only, and keys and weights are
    None. `launch_args` as for `sky_forward`; with `order`, the workspace
    and `_Plan` of the scatter of these taps, the kernel also writes the
    ordering's first-pass digit counts there; `stream`, the current
    stream's handle where the caller is in the rays' device context;
    `out` (CUDA only), the buffers (d_out, keys, weights) to write, the
    last two None without `taps`."""
    global BACKWARD_LAUNCHES
    env_mips = scene.env_mips if env_mips is None else tuple(env_mips)
    if outputs.device.type == "cpu":
        d_out, keys, wts = sky_taps_reference(scene, settings, outputs, ct,
                                              env_mips)
        return (d_out, keys, wts) if taps else (d_out, None, None)
    if outputs.device.type != "cuda":
        raise ValueError(f"no sky kernel for device {outputs.device}")
    tex, pdf, layout, ints, floats = launch_args or _kernel_args(
        scene, settings, outputs, env_mips)
    n, dev = outputs.shape[0], outputs.device
    _check(ct, "ct", (n, 3), torch.float32, dev)
    if out is None:
        d_out = torch.empty((n, 4), dtype=torch.float32, device=dev)
        keys = wts = None
        if taps:
            keys = torch.empty((n * TAPS,), dtype=torch.int32, device=dev)
            wts = torch.empty((n * TAPS, 3), dtype=torch.float32,
                              device=dev)
    else:
        d_out, keys, wts = out
        _check(d_out, "d_out", (n, 4), torch.float32, dev)
        if taps:
            _check(keys, "keys", (n * TAPS,), torch.int32, dev)
            _check(wts, "wts", (n * TAPS, 3), torch.float32, dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    hist, digit, n_texels = None, 0, 0
    if order is not None and taps:
        ws, plan = order
        hist, digit = ws.data_ptr() + 4 * plan.offs["hist"], plan.digit
        n_texels = int(tex.shape[0])
    launch = lambda st: _lib().halogen_sky_backward(
        outputs.data_ptr(), tex.data_ptr(), ptr(pdf),
        ctypes.addressof(layout), ct.data_ptr(), d_out.data_ptr(), ptr(keys),
        ptr(wts), hist, *ints, digit, n_texels, *floats, st)
    if stream is None:
        with torch.cuda.device(dev):
            err = launch(torch.cuda.current_stream().cuda_stream)
    else:
        err = launch(stream)
    if err != 0:
        raise RuntimeError(f"sky backward launch failed: CUDA error {err}")
    BACKWARD_LAUNCHES += 1
    return d_out, keys, wts


def order_plan(n_texels: int) -> tuple:
    """(bits, passes, digit bits) of the ordering over an atlas of
    `n_texels`: the bits of the largest texel, n_texels - 1, in passes of
    at most MAX_DIGIT_BITS (the gradient sky's 10,920 texels: 14 bits, two
    passes of 7; 698,880 texels: 20 bits, three of 7)."""
    bits = max(1, (n_texels - 1).bit_length())
    passes = -(-bits // MAX_DIGIT_BITS)
    return bits, passes, -(-bits // passes)


def _sum_plan(m: int) -> tuple:
    """(levels, carry slots a buffer) of the sums over m ordered taps: a
    level leaves two carries a tile until one tile is left (csrc/sky.cu
    sum_levels); the slots a multiple of 4, for 16-byte loads."""
    levels, ub = 1, m
    while ub > SUM_TILE:
        ub = 2 * -(-ub // SUM_TILE)
        levels += 1
    return levels, 4 * -(-2 * -(-m // SUM_TILE) // 4)


def _check_scatter(keys: torch.Tensor, wts, n_texels: int) -> None:
    m, dev = keys.shape[0], keys.device
    _check(keys, "keys", (m,), torch.int32, dev)
    if wts is not None:
        _check(wts, "wts", (m, 3), torch.float32, dev)
    if n_texels < 1:
        raise ValueError("the atlas has no texel")
    if m >= 2 ** 31:
        raise ValueError("too many taps for one scatter")


class _Plan(NamedTuple):
    """The launches of a scatter of m keys into n_texels, and the layout of
    its one int32 workspace: word offsets of the ordering's keys and tap
    indices (and their copies between passes), its histograms, digit
    totals and kept count, then the sums' carry keys, carry weights (as
    float32) and per-level counts, each 16-byte aligned."""
    m: int
    passes: int
    digit: int
    levels: int
    cap: int
    offs: dict
    words: int


@functools.lru_cache(maxsize=64)
def _plan(m: int, n_texels: int) -> _Plan:
    _, passes, digit = order_plan(n_texels)
    levels, cap = _sum_plan(m)
    sizes = dict(keys=m, idx=m, tmp_keys=m, tmp_idx=m,
                 hist=(1 << digit) * -(-m // SORT_TILE), totals=1 << digit,
                 count=1, carry_keys=2 * cap, carry_vals=6 * cap,
                 counts=levels)
    offs, at = {}, 0
    for name, n in sizes.items():
        offs[name] = at
        at += -(-n // 4) * 4
    return _Plan(m, passes, digit, levels, cap, offs, at)


def _workspace(m: int, n_texels: int, dev) -> tuple:
    """(the int32 workspace, its `_Plan`) of a scatter of m keys."""
    plan = _plan(m, n_texels)
    return torch.empty((plan.words,), dtype=torch.int32, device=dev), plan


def _order(keys: torch.Tensor, n_texels: int, stream: int, order=None,
           counted: bool = False) -> tuple:
    """The ordering kernels on a CUDA device, on `stream` (the current
    device's), into `order` (a `_workspace`; a new one by default): its
    `keys` and `idx` then hold the keys ordered by texel and their tap
    indices, the first `count` of them (`counted`: the taps kernel wrote
    the first pass's digit counts there already). Returns the workspace
    and its `_Plan`; no host synchronization."""
    global ORDER_LAUNCHES
    ws, plan = order or _workspace(keys.shape[0], n_texels, keys.device)
    o = {k: ws.data_ptr() + 4 * v for k, v in plan.offs.items()}
    err = _lib().halogen_sky_order(
        keys.data_ptr(), o["keys"], o["idx"], o["tmp_keys"], o["tmp_idx"],
        o["hist"], o["totals"], o["count"], plan.m, n_texels, plan.passes,
        plan.digit, int(counted), stream)
    if err != 0:
        raise RuntimeError(f"sky ordering launch failed: CUDA error {err}")
    ORDER_LAUNCHES += 1
    return ws, plan


def _sums(ws: torch.Tensor, plan: _Plan, wts: torch.Tensor, n_texels: int,
          stream: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """The per-texel sum kernels on a CUDA device, on `stream` (the current
    device's), over the ordering in the workspace `ws` (`_order`'s):
    [n_texels, 3], or with `out` (a contiguous float32 [n_texels, 3]) each
    texel's sum added into it, out[t] + sum, the texels without a tap left
    as they were."""
    global SCATTER_LAUNCHES
    add = out is not None
    if add:
        _check(out, "out", (n_texels, 3), torch.float32, ws.device)
    else:
        out = torch.empty((n_texels, 3), dtype=torch.float32,
                          device=ws.device)
    o = {k: ws.data_ptr() + 4 * v for k, v in plan.offs.items()}
    err = _lib().halogen_sky_sum(
        o["keys"], o["idx"], wts.data_ptr(), o["count"], o["carry_keys"],
        o["carry_vals"], o["counts"], out.data_ptr(), plan.m, plan.cap,
        plan.levels, n_texels, int(add), stream)
    if err != 0:
        raise RuntimeError(f"sky sums launch failed: CUDA error {err}")
    SCATTER_LAUNCHES += 1
    return out


def order_texels(keys: torch.Tensor, n_texels: int):
    """(the keys in [0, n_texels) in the order of a stable sort by texel,
    their indices in `keys` as int32): the ordering kernels on a CUDA
    device (then one host synchronization to read the length), on the CPU
    `torch.sort(stable=True)`, its plain version."""
    _check_scatter(keys, None, n_texels)
    if keys.device.type == "cpu":
        ordered, perm = torch.sort(keys, stable=True)
        keep = (ordered >= 0) & (ordered < n_texels)
        return ordered[keep], perm[keep].to(torch.int32)
    if keys.device.type != "cuda":
        raise ValueError(f"no ordering kernel for device {keys.device}")
    if keys.shape[0] == 0:
        return keys, torch.empty_like(keys)
    with torch.cuda.device(keys.device):
        ws, plan = _order(keys, n_texels,
                          torch.cuda.current_stream().cuda_stream)
    c = int(ws[plan.offs["count"]].item())
    return (ws[plan.offs["keys"]:plan.offs["keys"] + c],
            ws[plan.offs["idx"]:plan.offs["idx"] + c])


def scatter_texels(keys: torch.Tensor, wts: torch.Tensor, n_texels: int,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """[n_texels, 3]: per texel t the sum of wts[j] over the j with
    keys[j] == t (keys < 0 are skipped). On a CUDA device the ordering
    kernels, then the per-texel sum kernels, in a fixed order (two calls
    give the same bits; keys >= n_texels are dropped there); on the CPU
    `index_add_`, in index order. With `out` (contiguous float32
    [n_texels, 3]) the sums are added into it and it is returned: on the
    card each texel's whole sum at once, out[t] + sum (so out + the sums
    into zeros, bit for bit); on the CPU `index_add_` into it."""
    _check_scatter(keys, wts, n_texels)
    m, dev = keys.shape[0], keys.device
    if out is not None:
        _check(out, "out", (n_texels, 3), torch.float32, dev)
    if dev.type == "cpu":
        keep = keys >= 0
        if out is None:
            out = torch.zeros((n_texels, 3), dtype=torch.float32)
        return out.index_add_(0, keys[keep].to(torch.int64), wts[keep])
    if dev.type != "cuda":
        raise ValueError(f"no scatter kernel for device {dev}")
    if m == 0:
        return (out if out is not None else
                torch.zeros((n_texels, 3), dtype=torch.float32, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        return _sums(*_order(keys, n_texels, stream), wts, n_texels, stream,
                     out)


def reduce_texels_model(keys: torch.Tensor, vals: torch.Tensor,
                        n_texels: int, tile: int = SUM_TILE) -> torch.Tensor:
    """Plain PyTorch model of the per-texel sum kernels
    (`sky_reduce_texels`), addition for addition: [n_texels, 3], per texel
    the sum of vals over its run in the ordered keys (all in [0,
    n_texels)). Levels of tiles of `tile` keys, a lane of 32 taking
    tile / 32 consecutive keys: each lane adds its keys since its last
    head (a key unlike the one before it) one after another; an inclusive
    segmented scan across the lanes (Hillis-Steele, the lower lanes' sum
    added first) gives each lane the partial of the run entering it, from
    which it walks its keys again. A run inside a tile is written, the
    tile's first and last runs become its two carries (the last (key, 0)
    where one run fills the tile), the next level's keys and values; one
    tile left writes every run. In float32 it gives the kernel's bits on
    any device."""
    out = torch.zeros((n_texels, 3), dtype=torch.float32, device=keys.device)
    keys, vals = keys.to(torch.int64), vals.to(torch.float32)
    while keys.numel():
        keys, vals = _reduce_level(keys, vals, out, tile)
    return out


def _reduce_level(keys, vals, out, tile):
    """One level of `reduce_texels_model`; returns the carries."""
    n, dev = keys.numel(), keys.device
    tiles, items = -(-n // tile), tile // LANES
    k = torch.full((tiles * tile,), -1, dtype=torch.int64, device=dev)
    k[:n] = keys
    v = torch.zeros((tiles * tile, 3), dtype=torch.float32, device=dev)
    v[:n] = vals
    prev = torch.cat([k.new_full((1,), -1), k[:-1]])
    nxt = torch.cat([k[1:], k.new_full((1,), -1)])
    first_of_tile = torch.arange(tiles * tile, device=dev) % tile == 0
    head = (first_of_tile | (prev != k)).view(tiles, LANES, items)
    tail = ((k >= 0) & ((nxt != k) | torch.roll(first_of_tile, -1))).view(
        tiles, LANES, items)
    k, v = k.view(tiles, LANES, items), v.view(tiles, LANES, items, 3)
    # each lane's partial since its last head
    part = v[:, :, 0].clone()
    for i in range(1, items):
        part = torch.where(head[:, :, i, None], v[:, :, i],
                           part + v[:, :, i])
    f = head.any(dim=2)
    lane = torch.arange(LANES, device=dev)
    d = 1
    while d < LANES:
        up_v = torch.zeros_like(part)
        up_v[:, d:] = part[:, :-d]
        up_f = torch.zeros_like(f)
        up_f[:, d:] = f[:, :-d]
        up = lane >= d
        part = torch.where((up & ~f)[..., None], up_v + part, part)
        f = f | (up & up_f)
        d *= 2
    run = torch.zeros_like(part)
    run[:, 1:] = part[:, :-1]
    sums = torch.empty_like(v)
    for i in range(items):
        run = torch.where(head[:, :, i, None], v[:, :, i], run + v[:, :, i])
        sums[:, :, i] = run
    k_first = k[:, 0, 0]
    k_last = keys[torch.clamp_max(torch.arange(1, tiles + 1, device=dev)
                                  * tile, n) - 1]
    if tiles == 1:
        out[k[tail]] = sums[tail]
        return keys[:0], vals[:0]
    first = tail & (k == k_first[:, None, None])
    last = tail & (k == k_last[:, None, None]) & ~first
    inner = tail & ~first & ~last
    out[k[inner]] = sums[inner]
    t_of = torch.arange(tiles, device=dev)[:, None, None].expand(k.shape)
    c_keys = torch.stack([k_first, k_last], dim=1)
    c_vals = torch.zeros((tiles, 2, 3), dtype=torch.float32, device=dev)
    c_vals[t_of[first], 0] = sums[first]
    c_vals[t_of[last], 1] = sums[last]
    return c_keys.reshape(-1), c_vals.reshape(-1, 3)


def sky_backward_reference(scene: SceneData, settings: RenderSettings,
                           outputs: torch.Tensor, ct: torch.Tensor,
                           env_mips=None):
    """Plain version of the pair's backward: torch autograd of
    (deferred_sky * ct).sum(); returns (d_out [N, 4], one cotangent per
    mip)."""
    env_mips = scene.env_mips if env_mips is None else tuple(env_mips)
    with torch.enable_grad():
        leaves = [m.detach().clone().requires_grad_(True) for m in env_mips]
        out = outputs.detach().clone().requires_grad_(True)
        sc = dataclasses.replace(scene, env_mips=tuple(leaves))
        col = deferred_sky(sc, settings, out)
        grads = torch.autograd.grad((col * ct).sum(), [out, *leaves],
                                    allow_unused=True)
    d_env = tuple(torch.zeros_like(x) if g is None else g
                  for g, x in zip(grads[1:], leaves))
    return grads[0][:, 3:7].contiguous(), d_env


def sky_backward_full(scene: SceneData, settings: RenderSettings,
                      outputs: torch.Tensor, ct: torch.Tensor, env_mips=None,
                      launch_args=None):
    """(d_out [N, 4], one cotangent per mip) of the sky pass: the backward
    kernel and the per-texel sum on a CUDA device, their plain versions
    on the CPU."""
    env_mips = scene.env_mips if env_mips is None else tuple(env_mips)
    n_texels = sum(int(m.shape[0]) * int(m.shape[1]) for m in env_mips)
    if outputs.device.type != "cuda" or outputs.shape[0] == 0:
        d_out, keys, wts = sky_backward(scene, settings, outputs, ct,
                                        env_mips, launch_args=launch_args)
        return d_out, split_mips(scatter_texels(keys, wts, n_texels),
                                 env_mips)
    # the taps kernel counts the ordering's first pass (its block is a tile)
    order = _workspace(outputs.shape[0] * TAPS, n_texels, outputs.device)
    with torch.cuda.device(outputs.device):
        stream = torch.cuda.current_stream().cuda_stream
        d_out, keys, wts = sky_backward(
            scene, settings, outputs, ct, env_mips, launch_args=launch_args,
            order=order, stream=stream)
        ordered = _order(keys, n_texels, stream, order, counted=True)
        out = _sums(*ordered, wts, n_texels, stream)
    return d_out, split_mips(out, env_mips)


def sky_backward_groups(scene: SceneData, settings: RenderSettings,
                        outputs: torch.Tensor, ct: torch.Tensor,
                        d_out: torch.Tensor, launch_args, env_mips,
                        want_env: bool) -> torch.Tensor | None:
    """The sky pass's backward of a chunk node's groups
    (`megakernel._FusedChunk`) on a CUDA device: for each group g of
    `outputs` [G, n, C], the last first (the order in which autograd runs
    one `SkyPass` a group), the taps kernel on its rows with the colour
    cotangent `ct` [n, 3], which every group shares, into `d_out[g]` ([G,
    n, 4]: the miss attenuation's and the accumulated roughness's
    cotangents, which the adjoint's sweep takes); with `want_env` also the
    ordering of its taps and their per-texel sums, added into one
    [n_texels, 3] buffer zeroed once. That buffer is what autograd adds up
    of one `SkyPass` a group, bit for bit (a texel's sums added in the
    same order); returned, or None without `want_env`. `launch_args` is
    `_kernel_args` of the chunk's forward (its atlas); one taps buffer and
    one workspace serve the groups in turn."""
    groups, n = outputs.shape[0], outputs.shape[1]
    dev = outputs.device
    if dev.type != "cuda":
        raise ValueError("the chunk node's sky backward runs on a CUDA "
                         "device")
    _check(d_out, "d_out", (groups, n, 4), torch.float32, dev)
    n_texels = int(launch_args[0].shape[0])
    flat = keys = wts = order = None
    if want_env:
        flat = torch.zeros((n_texels, 3), dtype=torch.float32, device=dev)
        keys = torch.empty((n * TAPS,), dtype=torch.int32, device=dev)
        wts = torch.empty((n * TAPS, 3), dtype=torch.float32, device=dev)
        order = _workspace(n * TAPS, n_texels, dev) if n else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for g in reversed(range(groups)):
            sky_backward(scene, settings, outputs[g], ct, env_mips,
                         taps=want_env, launch_args=launch_args, order=order,
                         stream=stream, out=(d_out[g], keys, wts))
            if order is not None:
                _sums(*_order(keys, n_texels, stream, order, counted=True),
                      wts, n_texels, stream, flat)
    return flat


class SkyPass(torch.autograd.Function):
    """The sky pass with the kernel pair: `sky_forward` forward; backward
    the cotangent of the outputs (the color's, and from the sky's the miss
    attenuation's and the accumulated roughness's) and of every mip."""

    @staticmethod
    def forward(ctx, *args):
        with annotate("halogen.wrap.sky"):
            return SkyPass._forward(ctx, *args)

    @staticmethod
    def backward(ctx, grad_color):
        with annotate("halogen.wrap.sky_backward"):
            return SkyPass._backward(ctx, grad_color)

    @staticmethod
    def _forward(ctx, scene, settings, outputs, *env_mips):
        ctx.scene, ctx.settings = scene, settings
        ctx.save_for_backward(outputs, *env_mips)
        # the atlas and layout once for both passes (the saved mips cannot
        # change in between: autograd checks their versions)
        ctx.launch_args = _kernel_args(scene, settings, outputs, env_mips)
        return sky_forward(scene, settings, outputs, env_mips,
                           ctx.launch_args)

    @staticmethod
    def _backward(ctx, grad_color):
        outputs, *env_mips = ctx.saved_tensors
        ct = grad_color.contiguous()
        want_env = any(ctx.needs_input_grad[3:])
        if want_env:
            d4, d_env = sky_backward_full(ctx.scene, ctx.settings, outputs,
                                          ct, env_mips, ctx.launch_args)
        else:
            d4 = sky_backward(ctx.scene, ctx.settings, outputs, ct,
                              env_mips, taps=False,
                              launch_args=ctx.launch_args)[0]
            d_env = (None,) * len(env_mips)
        d_outputs = None
        if ctx.needs_input_grad[2]:
            d_outputs = torch.zeros_like(outputs)
            d_outputs[:, 0:3] = ct
            d_outputs[:, 3:7] = d4
        return (None, None, d_outputs, *d_env)


def sky_color(scene: SceneData, settings: RenderSettings,
              outputs: torch.Tensor) -> torch.Tensor:
    """[N, 3] radiance from the per-ray outputs of the megakernel,
    differentiable in the outputs and the scene's mips: `SkyPass` on a CUDA
    device, `deferred_sky` with autograd on the CPU."""
    if not uses_sky(scene, settings):
        return outputs[:, 0:3]
    if outputs.device.type == "cuda":
        return SkyPass.apply(scene, settings, outputs, *scene.env_mips)
    return deferred_sky(scene, settings, outputs)
