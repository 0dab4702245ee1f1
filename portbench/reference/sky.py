"""The sky at the miss in plain PyTorch (a frozen copy of the port's plain
envmap lookup; the upstream's `sample_sky`, `HalgoenCompute.compute:
196-204, 938-946`): an equirectangular map with a 2x box-filtered mip
pyramid, looked up trilinearly at a float mip level, the azimuth wrapping
and the pole clamping as the hardware's `SampleLevel` does.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import normalize


def build_mips(image: torch.Tensor, num_mips: int = 6) -> list:
    """[H, W, 3] float32 -> its mips, finest first, each the 2x2 box mean
    of the one before (0.25 * (((a + b) + c) + d))."""
    mips = [image]
    for _ in range(num_mips - 1):
        cur = mips[-1]
        h, w = cur.shape[:2]
        if h < 2 or w < 2:
            break
        cur = cur[:h // 2 * 2, :w // 2 * 2]
        mips.append(0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                            + cur[0::2, 1::2] + cur[1::2, 1::2]))
    return mips


def dir_to_equirect_uv(d: torch.Tensor):
    """Direction (y-up) -> (u, v): u wraps the azimuth atan2(x, -z), v runs
    from 0 at +y to 1 at -y."""
    d = normalize(d)
    u = (torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * np.pi)) + 0.5
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / np.pi
    return u, v


def _bilinear(atlas, hs, ws, offs, u, v, li):
    """Bilinear tap of mip `li` (per ray) from the flat [T, 3] atlas."""
    h, w, off = hs[li], ws[li], offs[li]
    wi, hi = w.to(torch.int64), h.to(torch.int64)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), wi)
    x1i = torch.remainder(x0i + 1, wi)
    y0u = y0.to(torch.int64)
    y0i = torch.clamp(torch.clamp_max(y0u, hi - 1), min=0)
    y1i = torch.clamp(torch.clamp_max(y0u + 1, hi - 1), min=0)
    c00, c01 = atlas[off + y0i * wi + x0i], atlas[off + y0i * wi + x1i]
    c10, c11 = atlas[off + y1i * wi + x0i], atlas[off + y1i * wi + x1i]
    top = c00 + (c01 - c00) * wx
    bot = c10 + (c11 - c10) * wx
    return top + (bot - top) * wy


def sample_sky(mips: list, direction: torch.Tensor,
               level: torch.Tensor) -> torch.Tensor:
    """[N, 3] radiance of the map along `direction` at the float mip
    `level` [N]: bilinear in the two bracketing mips, blended linearly."""
    dev = direction.device
    n_mips = len(mips)
    sizes = [(int(m.shape[0]), int(m.shape[1])) for m in mips]
    offs = torch.tensor(np.cumsum([0] + [h * w for h, w in sizes])[:-1],
                        dtype=torch.int64, device=dev)
    hs = torch.tensor([h for h, _ in sizes], dtype=torch.float32, device=dev)
    ws = torch.tensor([w for _, w in sizes], dtype=torch.float32, device=dev)
    atlas = torch.cat([m.reshape(-1, 3) for m in mips])
    level = torch.clamp(level.to(torch.float32), 0.0, float(n_mips - 1))
    l0 = torch.clamp(torch.floor(level).to(torch.int64), 0, n_mips - 2)
    frac = (level - l0.to(torch.float32))[..., None]
    u, v = dir_to_equirect_uv(direction)
    a = _bilinear(atlas, hs, ws, offs, u, v, l0)
    b = _bilinear(atlas, hs, ws, offs, u, v,
                  torch.clamp_max(l0 + 1, n_mips - 1))
    return a + (b - a) * frac
