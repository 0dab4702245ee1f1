"""Sampler distribution visualizer (PyTorch port of
`halogen_tpu/sampler/debug.py`; the reference's `Debug/DebugSobol.compute`
and `HalogenDebugger.cs`).

Plots N Owen-scrambled Sobol points through the Blackman-Harris inverse
CDF into a 2D histogram image, to check the sampler's and the pixel
filter's distributions by eye (DebugSobol.compute:19-41 splats 100k
samples around the texture's center): one histogram scatter-add instead of
a single-thread loop.
"""

from __future__ import annotations

import numpy as np
import torch

from halogen_tpu_torch.core.types import target_device
from halogen_tpu_torch.sampler.mappings import inverse_blackman_harris_cdf
from halogen_tpu_torch.sampler.sobol import ld_sample_2d


def sobol_filter_image(size: int = 256, count: int = 100_000,
                       seed: int = 0, spread: float = 0.45,
                       through_filter: bool = True,
                       device="cuda") -> np.ndarray:
    """[size, size, 3] float32 density plot of `count` Sobol points,
    computed on `device` (the card unless the caller asks for the CPU).

    through_filter=True maps each sample through the Blackman-Harris
    inverse CDF around the image center (the DebugSobol behavior); False
    plots the raw [0,1)^2 points (a stratification check)."""
    dev = target_device(device)
    idx = torch.arange(count, dtype=torch.int64, device=dev)
    u, v = ld_sample_2d(idx, 0, seed)
    if through_filter:
        # invBH maps to ~[-0.5, 0.5]; scaled into the image around center
        x = 0.5 + inverse_blackman_harris_cdf(u) * 2.0 * spread
        y = 0.5 + inverse_blackman_harris_cdf(v) * 2.0 * spread
    else:
        x, y = u, v
    xi = torch.clamp((x * size).to(torch.int32), 0, size - 1)
    yi = torch.clamp((y * size).to(torch.int32), 0, size - 1)
    hist = torch.bincount((yi * size + xi).to(torch.int64),
                          minlength=size * size).to(torch.float32)
    hist = hist.reshape(size, size).cpu().numpy()
    peak = hist.max() if hist.max() > 0 else 1.0
    return (hist / peak)[..., None].repeat(3, axis=-1).astype(np.float32)


def sobol_discrepancy_probe(count: int = 4096, dims=(0, 5, 10),
                            seed: int = 1, device="cuda") -> dict:
    """Per dimension pair, a discrepancy proxy for test assertions: the
    mean squared deviation of the 16x16 stratum counts from uniform, over
    the expected count."""
    dev = target_device(device)
    idx = torch.arange(count, dtype=torch.int64, device=dev)
    out = {}
    for d in dims:
        u, v = ld_sample_2d(idx, d, seed)
        cell = (torch.clamp((v * 16).to(torch.int32), 0, 15) * 16
                + torch.clamp((u * 16).to(torch.int32), 0, 15))
        h = torch.bincount(cell.to(torch.int64), minlength=256)
        expected = count / 256.0
        out[d] = float(torch.mean((h - expected) ** 2) / expected)
    return out
