"""Vector geometry in plain PyTorch (a frozen copy of the port's plain
math, from `HalgoenCompute.compute` of the upstream renderer): 3-vectors
in the trailing axis, the SoA variants on 3-tuples of components. Dot
products are written out as (x + y) + z so the sum order does not depend
on the backend's reduction.
"""

from __future__ import annotations

import numpy as np
import torch

INF = float("inf")
HIT_EPS = float(np.float32(1e-4))  # hitDistanceEpsilon (compute:360,383)
OFFSET_EPS = float(np.float32(1e-4))  # surface offset (compute:710,724)
DET_EPS = float(np.float32(1e-8))  # parallel-ray cutoff (compute:321)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3] cross product, each component a product difference (the
    JAX `jnp.cross`'s formula, and the kernels' `cross3`)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as IEEE 754 asks and as XLA's and
    CUDA's `sqrtf` give it. torch's float32 sqrt on the CPU is not: it
    misses by an ulp on ~0.6% of inputs, which an NEE weight can grow
    into percents of a ray's color. There the root is taken in float64,
    whose rounding to float32 is the correctly rounded float32 root."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    n = sqrt(dot(v, v))[..., None]
    return v / torch.clamp_min(n, eps) if eps else v / n


def dot_soa(a, b):
    """3-tuples of component tensors -> broadcast dot product."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross_soa(a, b):
    """3-tuples of component tensors -> 3-tuple cross product."""
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def triangle_intersect_soa(o, d, v0, e1, e2):
    """Double-sided Möller-Trumbore on component tuples
    (HalgoenCompute.compute:307-355). Returns (t, u, v, orientation); t is
    +inf on a miss, orientation = sign(det)."""
    pvec = cross_soa(d, e2)
    det = dot_soa(pvec, e1)
    parallel = torch.abs(det) < DET_EPS
    inv_det = 1.0 / torch.where(parallel, 1.0, det)
    tvec = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = dot_soa(tvec, pvec) * inv_det
    qvec = cross_soa(tvec, e1)
    v = dot_soa(d, qvec) * inv_det
    t = dot_soa(e2, qvec) * inv_det
    valid = ((~parallel) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > 0.0))
    t = torch.where(valid, t, INF)
    return t, u, v, torch.sign(det)


def ray_aabb_soa(lo, hi, o, inv_d):
    """Slab test on component tuples (HalgoenCompute.compute:244-259).
    Returns tMin, or +inf on a miss."""
    t1x = (lo[0] - o[0]) * inv_d[0]
    t2x = (hi[0] - o[0]) * inv_d[0]
    t1y = (lo[1] - o[1]) * inv_d[1]
    t2y = (hi[1] - o[1]) * inv_d[1]
    t1z = (lo[2] - o[2]) * inv_d[2]
    t2z = (hi[2] - o[2]) * inv_d[2]
    tmin = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.minimum(t1z, t2z),
    )
    tmax = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.maximum(t1z, t2z),
    )
    return torch.where(tmax > torch.clamp_min(tmin, 0.0), tmin, INF)


def sphere_intersect_soa(o, d, c, radius):
    """Quadratic sphere test on component tuples
    (HalgoenCompute.compute:266-303): the near root, or the far root with
    orientation -1 when the origin is inside. Misses are +inf."""
    oc = (o[0] - c[0], o[1] - c[1], o[2] - c[2])
    b = 2.0 * dot_soa(oc, d)
    cq = dot_soa(oc, oc) - radius * radius
    disc = b * b - 4.0 * cq
    sq = sqrt(torch.clamp_min(disc, 0.0))
    t_near = (-b - sq) * 0.5
    t_far = (-b + sq) * 0.5
    inside = t_near < 0.0
    t = torch.where(inside, t_far, t_near)
    orientation = torch.where(inside, -1.0, 1.0)
    t = torch.where(disc >= 0.0, t, INF)
    return t, orientation


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror reflection (HalgoenCompute.compute:506-509)."""
    return incident - 2.0 * dot(incident, normal)[..., None] * normal


def refract(incident: torch.Tensor, normal: torch.Tensor, n1, n2):
    """Snell refraction with total-internal-reflection handling
    (HalgoenCompute.compute:557-572). Returns (direction, tir_mask)."""
    cos_theta = torch.clamp_max(dot(-incident, normal), 1.0)
    sin_theta = sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    eta = n1 / n2
    tir = eta * sin_theta > 1.0
    r_perp = eta[..., None] * (incident + cos_theta[..., None] * normal)
    perp_len2 = dot(r_perp, r_perp)
    r_par = -sqrt(torch.abs(1.0 - perp_len2))[..., None] * normal
    refracted = r_perp + r_par
    reflected = reflect(incident, normal)
    return torch.where(tir[..., None], reflected, refracted), tir


def schlick_adjusted_specular(n1, n2, normal, incident, min_spec, max_spec):
    """Fresnel-adjusted specular probability (HalgoenCompute.compute:519-540):
    Schlick with entering/exiting handling, lerped into [min_spec, max_spec]."""
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    cos_x = -dot(normal, incident)
    n = n1 / n2
    sin_t2 = n * n * (1.0 - cos_x * cos_x)
    exiting = n1 > n2
    tir = exiting & (sin_t2 > 1.0)
    cos_x = torch.where(
        exiting, sqrt(torch.clamp_min(1.0 - sin_t2, 0.0)), cos_x)
    x = 1.0 - cos_x
    ret = r0 + (1.0 - r0) * x * x * x * x * x
    out = min_spec + (max_spec - min_spec) * ret
    return torch.where(tir, max_spec, out)


def lambertian_scatter(normal: torch.Tensor,
                       random_unit: torch.Tensor) -> torch.Tensor:
    """normalize(normal + uniform unit vector), guarding the degenerate
    opposite-vector case (HalgoenCompute.compute:491-501)."""
    s = normal + random_unit
    tiny = dot(s, s)[..., None] < float(np.float32(1e-16))
    s = torch.where(tiny, normal, s)
    return normalize(s)


def lerp(a, b, t):
    return a + (b - a) * t
