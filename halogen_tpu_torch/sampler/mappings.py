"""Sample warps and the pixel reconstruction filter (PyTorch port of
`halogen_tpu/sampler/mappings.py`; reference `HalogenRandom.hlsl`)."""

from __future__ import annotations

import numpy as np
import torch

from halogen_tpu_torch.core.math import sqrt

_TWO_PI = float(np.float32(2.0 * np.pi))


def unit_vector_from_2d(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere from two [0,1) samples
    (HalogenRandom.hlsl:282-298). Returns [..., 3]."""
    theta = u * _TWO_PI
    cos_phi = 2.0 * v - 1.0
    sin_phi = sqrt(torch.clamp_min(1.0 - cos_phi * cos_phi, 0.0))
    return torch.stack([sin_phi * torch.cos(theta), sin_phi * torch.sin(theta),
                        cos_phi], dim=-1)


def point_in_circle(radius, u: torch.Tensor, v: torch.Tensor):
    """Point inside a disc of `radius` (HalogenRandom.hlsl:303-308); the
    radial coordinate is linear in the sample, as in the reference."""
    theta = u * _TWO_PI
    r = radius * v
    return torch.cos(theta) * r, torch.sin(theta) * r


def blackman_harris_filter(x: torch.Tensor, width) -> torch.Tensor:
    """Blackman-Harris window evaluated at x in [0, width]
    (HalogenRandom.hlsl:314-317)."""
    phi = _TWO_PI * (x / width)
    return (0.35875 - 0.48829 * torch.cos(phi) + 0.14128 * torch.cos(2.0 * phi)
            - 0.01168 * torch.cos(3.0 * phi))


def _arctanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.log((1.0 + x) / (1.0 - x))


def inverse_blackman_harris_cdf(x: torch.Tensor) -> torch.Tensor:
    """Inverse-transform sampling of the Blackman-Harris distribution via
    the reference's analytic CDF-inverse approximation
    (HalogenRandom.hlsl:328-330). Maps [0,1) -> ~[-0.5, 0.5]."""
    return _arctanh(x * 1.99221575606 - 0.99610787803) / 6.24
