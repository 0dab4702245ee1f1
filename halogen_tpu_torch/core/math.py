"""Vectorized geometry math (PyTorch port of the parts of
`halogen_tpu/core/math.py` the brute-force slice uses).

3-vectors sit in the trailing axis ([..., 3]); the SoA variants take
3-tuples of component tensors. Each function keeps the JAX function's
association order. Dot products are written out as (x + y) + z so the
sum order does not depend on the backend's reduction.
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


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    n = torch.sqrt(dot(v, v))[..., None]
    return v / torch.clamp_min(n, eps) if eps else v / n


def transform_point(mat: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a [4, 4] affine matrix to [..., 3] points (w = 1)."""
    return p @ mat[:3, :3].T + mat[:3, 3]


def transform_dir(mat: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Apply a [4, 4] matrix to [..., 3] directions (w = 0)."""
    return d @ mat[:3, :3].T


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
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
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
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    eta = n1 / n2
    tir = eta * sin_theta > 1.0
    r_perp = eta[..., None] * (incident + cos_theta[..., None] * normal)
    perp_len2 = dot(r_perp, r_perp)
    r_par = -torch.sqrt(torch.abs(1.0 - perp_len2))[..., None] * normal
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
        exiting, torch.sqrt(torch.clamp_min(1.0 - sin_t2, 0.0)), cos_x)
    x = 1.0 - cos_x
    ret = r0 + (1.0 - r0) * x * x * x * x * x
    out = min_spec + (max_spec - min_spec) * ret
    return torch.where(tir, max_spec, out)


def procedural_glossy_pdf(omega: torch.Tensor, mirror: torch.Tensor,
                          alpha: torch.Tensor,
                          normal: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of the reference's procedural glossy lobe
    `normalize(lerp(reflect(d, n), dd, a))`, dd cosine-distributed about n
    (HalgoenCompute.compute:691-704). With a = roughness^2 the point
    (1 - a) * mirror + a * dd lies on a sphere of radius a; its density
    projects to the direction omega with the sphere-to-solid-angle
    Jacobian, summed over the positive roots t of |omega t - c| = a:

        pdf(omega) = sum cos(dd_i . n) / pi * t_i^2 / (a^2 |omega . dd_i|)

    A delta lobe (a = 0) gets 0. Port of the JAX `procedural_glossy_pdf`."""
    a1 = alpha
    b = (1.0 - a1) * dot(omega, mirror)
    c = (1.0 - a1) * (1.0 - a1) - a1 * a1
    disc = b * b - c
    eps = float(np.float32(1e-6))
    exists = (a1 > eps) & (disc >= 0.0)
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    a_safe = torch.clamp_min(a1, eps)
    total = torch.zeros_like(b)
    for t in (b - sq, b + sq):
        valid = exists & (t > eps)
        t_safe = torch.where(valid, t, 1.0)
        dd = (omega * t_safe[..., None]
              - (1.0 - a_safe)[..., None] * mirror) / a_safe[..., None]
        cos_dd = torch.clamp_min(dot(dd, normal), 0.0)
        dens = (cos_dd * float(np.float32(1.0 / np.pi))
                * t_safe * t_safe
                / (a_safe * a_safe
                   * torch.clamp_min(torch.abs(dot(omega, dd)), eps)))
        total = total + torch.where(valid, dens, 0.0)
    return total


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
