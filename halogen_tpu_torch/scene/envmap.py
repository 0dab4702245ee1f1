"""Environment map: equirectangular radiance map with a mip pyramid
(PyTorch port of `halogen_tpu/scene/envmap.py`).

The host side is numpy, as in the JAX package: `Envmap` holds the mips
(2x box-filtered, finest first) and `build_env_cdf` the luminance alias
tables for next-event estimation. The lookups are torch:
`sample_env_packed` is the trilinear sky lookup at a float mip level with
the azimuth wrap and pole clamp of the reference's hardware `SampleLevel`
(HalgoenCompute.compute:196-204, 940-945); `sample_env_draw` is the
alias-table NEE draw, whose radiance is the exact texel the pdf tables
were built from; `env_pdf` is the solid-angle pdf that MIS weights
against. Each keeps the JAX function's formulas and association order.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from halogen_tpu_torch.core.math import normalize
from halogen_tpu_torch.core.types import target_device

_PI = float(np.float32(np.pi))


@dataclasses.dataclass
class Envmap:
    """Host-side envmap: list of [H, W, 3] float32 mips, finest first."""

    mips: List[np.ndarray]

    @staticmethod
    def from_equirect(image: np.ndarray, num_mips: int = 6) -> "Envmap":
        img = np.asarray(image, np.float32)
        assert img.ndim == 3 and img.shape[2] == 3
        mips = [img]
        for _ in range(num_mips - 1):
            cur = mips[-1]
            h, w = cur.shape[:2]
            if h < 2 or w < 2:
                break
            h2, w2 = h // 2 * 2, w // 2 * 2
            cur = cur[:h2, :w2]
            mips.append(
                0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                        + cur[0::2, 1::2] + cur[1::2, 1::2])
            )
        return Envmap(mips)

    @staticmethod
    def constant(color, size: int = 8) -> "Envmap":
        img = np.broadcast_to(
            np.asarray(color, np.float32), (size, 2 * size, 3)
        ).copy()
        return Envmap.from_equirect(img, num_mips=2)

    @staticmethod
    def gradient_sky(
        horizon=(0.1, 0.1, 0.1), zenith=(0.5, 0.7, 1.0), scale=0.7,
        height: int = 64,
    ) -> "Envmap":
        """The commented-out procedural sky in the reference
        (HalgoenCompute.compute:198-199): lerp(horizon, zenith, 0.5*(y+1)) * scale."""
        h, w = height, height * 2
        theta = (np.arange(h) + 0.5) / h * np.pi  # [0, pi] from +y pole
        y = np.cos(theta)
        v = 0.5 * (y + 1.0)
        row = (np.outer(1 - v, np.asarray(horizon))
               + np.outer(v, np.asarray(zenith))) * scale
        img = np.repeat(row[:, None, :], w, axis=1).astype(np.float32)
        return Envmap.from_equirect(img)


class EnvCDF(NamedTuple):
    """Luminance-distribution tables for envmap next-event estimation
    (Walker/Vose alias tables over the solid-angle-weighted luminance), as
    tensors. `draw_static` holds one row per texel: alias_p | alias_j (as
    float32) | pdf[texel] | pdf[alias_j]."""

    alias_p: torch.Tensor  # [H*W] stay probability
    alias_j: torch.Tensor  # [H*W] int32 alias texel
    pdf: torch.Tensor  # [H, W] solid-angle pdf
    draw_static: torch.Tensor  # [H*W, 4]

    def to(self, device) -> "EnvCDF":
        return EnvCDF(*(t.to(device) for t in self))


def build_env_cdf(env: np.ndarray, device="cuda") -> EnvCDF:
    """Alias tables + pdf over solid-angle-weighted luminance of an
    equirect map [H, W, 3]; pdf is w.r.t. solid angle. On the card unless
    the caller asks for the CPU."""
    device = target_device(device)
    h, w = env.shape[:2]
    lum = np.asarray(env, np.float32) @ np.asarray(
        [0.2126, 0.7152, 0.0722], np.float32)
    sin_theta = np.sin((np.arange(h) + 0.5) / h * np.pi).astype(np.float32)
    weight = lum * sin_theta[:, None] + 1e-12
    # pdf(direction) = weight / (total * texel_solid_angle)
    texel_sa = (2 * np.pi / w) * (np.pi / h) * sin_theta[:, None]
    pdf = weight / (weight.sum() * texel_sa)

    # Vose alias construction (float64 for a clean partition)
    p = (weight / weight.sum()).reshape(-1).astype(np.float64)
    n = p.size
    scaled = p * n
    alias_p = np.ones(n, np.float64)
    alias_j = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        alias_p[s] = scaled[s]
        alias_j[s] = g
        scaled[g] = scaled[g] - (1.0 - scaled[s])
        (small if scaled[g] < 1.0 else large).append(g)
    for i in small + large:
        alias_p[i] = 1.0
    pdf_flat = pdf.reshape(-1)
    draw_static = np.stack(
        [alias_p.astype(np.float32), alias_j.astype(np.float32),
         pdf_flat.astype(np.float32),
         pdf_flat[alias_j].astype(np.float32)], axis=1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return EnvCDF(t(alias_p.astype(np.float32)), t(alias_j.astype(np.int32)),
                  t(pdf.astype(np.float32)), t(draw_static))


def dir_to_equirect_uv(d: torch.Tensor):
    """Direction [..., 3] (y-up) -> equirect (u, v) in [0, 1): u wraps the
    azimuth (atan2(x, -z)), v runs 0 at +y (zenith) to 1 at -y."""
    d = normalize(d)
    u = (torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * np.pi)) + 0.5
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / np.pi
    return u, v


def sample_env_mip_nearest(mip: torch.Tensor,
                           direction: torch.Tensor) -> torch.Tensor:
    """Nearest-texel lookup of one [H, W, 3] mip for [..., 3] directions."""
    h, w = mip.shape[0], mip.shape[1]
    u, v = dir_to_equirect_uv(direction)
    x = torch.clamp((u * w).to(torch.int32), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int32), 0, h - 1)
    return mip.reshape(-1, 3)[y * w + x]


def sample_env_mip(mip: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of one [H, W, 3] mip: texel centers at
    (i + 0.5) / size, the azimuth axis wraps, the polar axis clamps (each
    row index clamped on its own, from the unclamped y0)."""
    h, w = mip.shape[0], mip.shape[1]
    u, v = dir_to_equirect_uv(direction)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), w)
    x1i = torch.remainder(x0i + 1, w)
    y0u = y0.to(torch.int32)
    y0i = torch.clamp(y0u, 0, h - 1)
    y1i = torch.clamp(y0u + 1, 0, h - 1)
    flat = mip.reshape(-1, 3)
    c00, c01 = flat[y0i * w + x0i], flat[y0i * w + x1i]
    c10, c11 = flat[y1i * w + x0i], flat[y1i * w + x1i]
    top = c00 + (c01 - c00) * wx
    bot = c10 + (c11 - c10) * wx
    return top + (bot - top) * wy


def _atlas_layout(env_mips, device):
    sizes = [(int(m.shape[0]), int(m.shape[1])) for m in env_mips]
    offs = np.cumsum([0] + [h * w for h, w in sizes])[:-1]
    hs = torch.tensor([h for h, _ in sizes], dtype=torch.float32,
                      device=device)
    ws = torch.tensor([w for _, w in sizes], dtype=torch.float32,
                      device=device)
    return hs, ws, torch.tensor(offs, dtype=torch.int64, device=device)


def _bilin_atlas(atlas, hs, ws, offs, u, v, li, packed: bool):
    """Bilinear tap of mip `li` (per ray) from a flat atlas of all mips:
    [T, 3] texels, or [T, 12] footprint rows when `packed`."""
    h, w, off = hs[li], ws[li], offs[li]
    wi, hi = w.to(torch.int64), h.to(torch.int64)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), wi)
    y0u = y0.to(torch.int64)
    y0i = torch.clamp(torch.clamp_max(y0u, hi - 1), min=0)
    if packed:
        # the footprint row bakes y1 = min(y0 + 1, H - 1); above the top
        # texel center (y0u = -1) both taps must be row 0, which the
        # stored (row0, row1) pair reproduces with wy forced to 0
        wy = torch.where((y0u < 0)[..., None], 0.0, wy)
        row = atlas[off + y0i * wi + x0i]
        c00, c01 = row[..., 0:3], row[..., 3:6]
        c10, c11 = row[..., 6:9], row[..., 9:12]
    else:
        x1i = torch.remainder(x0i + 1, wi)
        y1i = torch.clamp(torch.clamp_max(y0u + 1, hi - 1), min=0)
        c00, c01 = atlas[off + y0i * wi + x0i], atlas[off + y0i * wi + x1i]
        c10, c11 = atlas[off + y1i * wi + x0i], atlas[off + y1i * wi + x1i]
    top = c00 + (c01 - c00) * wx
    bot = c10 + (c11 - c10) * wx
    return top + (bot - top) * wy


def _trilinear(env_mips, atlas, direction, level, packed: bool):
    n_mips = len(env_mips)
    hs, ws, offs = _atlas_layout(env_mips, direction.device)
    level = torch.clamp(level.to(torch.float32), 0.0, float(n_mips - 1))
    if n_mips == 1:
        l0 = torch.zeros(direction.shape[:-1], dtype=torch.int64,
                         device=direction.device)
    else:
        l0 = torch.clamp(torch.floor(level).to(torch.int64), 0, n_mips - 2)
    frac = (level - l0.to(torch.float32))[..., None]
    u, v = dir_to_equirect_uv(direction)
    a = _bilin_atlas(atlas, hs, ws, offs, u, v, l0, packed)
    if n_mips == 1:
        return a
    b = _bilin_atlas(atlas, hs, ws, offs, u, v,
                     torch.clamp_max(l0 + 1, n_mips - 1), packed)
    return a + (b - a) * frac


def sample_env(env_mips: Tuple[torch.Tensor, ...], direction: torch.Tensor,
               level: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of the pyramid at per-ray float mip `level`:
    bilinear within the two bracketing mips and a linear blend between
    them, from one flat texel atlas of every mip."""
    if not env_mips:
        return torch.zeros(direction.shape[:-1] + (3,),
                           device=direction.device)
    if len(env_mips) == 1:
        return sample_env_mip(env_mips[0], direction)
    atlas = torch.cat([m.reshape(-1, 3) for m in env_mips])
    return _trilinear(env_mips, atlas, direction, level, packed=False)


def pack_footprint(mip: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] mip -> [H*W, 12] bilinear-footprint rows: the 2x2 texel
    quad anchored at (y, x) with the azimuth wrap on x and the pole clamp
    on y baked in."""
    xp = torch.roll(mip, -1, dims=1)                    # (x+1 mod W, y)
    yc = torch.cat([mip[1:], mip[-1:]], dim=0)          # (x, min(y+1, H-1))
    xyc = torch.cat([xp[1:], xp[-1:]], dim=0)
    return torch.cat([mip, xp, yc, xyc], dim=2).reshape(-1, 12)


def sample_env_packed(env_mips: Tuple[torch.Tensor, ...],
                      direction: torch.Tensor,
                      level: torch.Tensor) -> torch.Tensor:
    """`sample_env` with footprint-packed rows: the same taps and blends
    (equal to it bit for bit), one row read per bilinear tap."""
    if not env_mips:
        return torch.zeros(direction.shape[:-1] + (3,),
                           device=direction.device)
    atlas = torch.cat([pack_footprint(m) for m in env_mips])
    return _trilinear(env_mips, atlas, direction, level, packed=True)


def env_draw_table(cdf: EnvCDF, env0: torch.Tensor) -> torch.Tensor:
    """[T, 10] rows of one NEE draw: `draw_static` | radiance of the
    texel | radiance of its alias (from the finest mip `env0`)."""
    flat = env0.reshape(-1, 3)
    return torch.cat([cdf.draw_static, flat, flat[cdf.alias_j]], dim=1)


def sample_env_direction(cdf: EnvCDF, u1, u2):
    """Alias-method direction from the luminance distribution: ([..., 3]
    directions, solid-angle pdf [...]). `u1` picks the texel, `u2` is the
    stay/alias threshold."""
    h, w = cdf.pdf.shape
    n = h * w
    r = torch.clamp(u1, 0.0, float(np.float32(1.0 - 1e-7))) * n
    idx = torch.clamp(r.to(torch.int64), 0, n - 1)
    texel = torch.where(u2 < cdf.alias_p[idx], idx,
                        cdf.alias_j[idx].to(torch.int64))
    return _texel_direction(texel, h, w), cdf.pdf.reshape(-1)[texel]


def _texel_direction(texel, h: int, w: int) -> torch.Tensor:
    row = texel // w
    col = texel - row * w
    theta = (row.to(torch.float32) + 0.5) / h * np.pi
    phi = ((col.to(torch.float32) + 0.5) / w - 0.5) * 2.0 * np.pi
    sin_t = torch.sin(theta)
    return torch.stack([sin_t * torch.sin(phi), torch.cos(theta),
                        -sin_t * torch.cos(phi)], dim=-1)


def sample_env_draw(cdf: EnvCDF, env0: torch.Tensor, u1, u2,
                    with_texel: bool = False):
    """One-row NEE draw: ([..., 3] direction, pdf [...], radiance
    [..., 3]), and with `with_texel` the drawn texel [...] (int64, the
    alias's where the draw took it). The radiance is the exact texel value
    of the finest mip `env0`. The row is the one the CUDA kernel reads
    (`env_draw_table`)."""
    h, w = cdf.pdf.shape
    n = h * w
    r = torch.clamp(u1, 0.0, float(np.float32(1.0 - 1e-7))) * n
    idx = torch.clamp(r.to(torch.int64), 0, n - 1)
    row = env_draw_table(cdf, env0)[idx]
    stay = u2 < row[..., 0]
    texel = torch.where(stay, idx, row[..., 1].to(torch.int64))
    pdf = torch.where(stay, row[..., 2], row[..., 3])
    rad = torch.where(stay[..., None], row[..., 4:7], row[..., 7:10])
    if with_texel:
        return _texel_direction(texel, h, w), pdf, rad, texel
    return _texel_direction(texel, h, w), pdf, rad


def env_pdf(cdf: EnvCDF, direction: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of the luminance distribution for [..., 3]
    directions (the MIS weight of BRDF samples that reach the sky)."""
    h, w = cdf.pdf.shape
    u, v = dir_to_equirect_uv(direction)
    x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return cdf.pdf[y, x]
