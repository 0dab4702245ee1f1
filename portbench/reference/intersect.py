"""Closest hits in plain PyTorch: every sphere by the quadratic, the
triangles through `accel.py`, and the upstream's rule between them
(`HalgoenCompute.compute:452`): a triangle must beat the sphere hit by
HIT_EPS and lie inside the far plane. The shading normal of a triangle is
interpolated from its vertex normals by the hit's barycentrics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import (
    HIT_EPS,
    INF,
    normalize,
    ray_aabb_soa,
    sphere_intersect_soa,
    triangle_intersect_soa,
)
from .scene import RefScene


class Hit(NamedTuple):
    t: torch.Tensor  # [N], +inf on a miss
    pos: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3]
    orientation: torch.Tensor  # [N] +1 outside, -1 inside
    material: torch.Tensor  # [N] int64


def _spheres(scene: RefScene, origin, direction, far):
    n = origin.shape[0]
    if scene.num_spheres == 0:
        return (torch.full((n,), INF, device=origin.device),
                torch.zeros((n,), dtype=torch.int64, device=origin.device),
                torch.ones((n,), device=origin.device))
    o = tuple(origin[None, :, k] for k in range(3))
    d = tuple(direction[None, :, k] for k in range(3))
    inv_dv = 1.0 / torch.where(torch.abs(direction) < 1e-30, 1e-30,
                               direction)
    inv_d = tuple(inv_dv[None, :, k] for k in range(3))
    c = tuple(scene.sphere_center[:, k][:, None] for k in range(3))
    r = scene.sphere_radius[:, None]
    aabb_t = ray_aabb_soa(tuple(ck - r for ck in c),
                          tuple(ck + r for ck in c), o, inv_d)
    t, orient = sphere_intersect_soa(o, d, c, r)
    t = torch.where((aabb_t < far[None, :]) & (t > HIT_EPS), t, INF)
    best_t, arg = torch.min(t, dim=0)
    return best_t, arg, orient.gather(0, arg[None, :])[0]


def intersect(scene: RefScene, origin: torch.Tensor, direction: torch.Tensor,
              far: torch.Tensor) -> Hit:
    n = origin.shape[0]
    sp_t, sp_i, sp_s = _spheres(scene, origin, direction, far)
    if scene.accel is not None:
        tr_t, tri = scene.accel.closest(origin, direction,
                                        torch.full((n,), INF,
                                                   device=origin.device))
    else:
        tr_t = torch.full((n,), INF, device=origin.device)
        tri = torch.full((n,), -1, dtype=torch.int64, device=origin.device)
    mesh_wins = (tr_t < sp_t - HIT_EPS) & (tr_t < far)
    t = torch.where(mesh_wins, tr_t, sp_t)
    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    pos = origin + direction * t_safe[:, None]

    if scene.num_spheres:
        sph_n = normalize((pos - scene.sphere_center[sp_i]) * sp_s[:, None],
                          eps=1e-20)
        sph_m = scene.sphere_material[sp_i]
    else:
        sph_n, sph_m = torch.zeros_like(pos), torch.zeros_like(sp_i)
    if scene.num_triangles:
        ti = torch.clamp_min(tri, 0)
        c = scene.accel.comps[ti]
        _, u, v, s = triangle_intersect_soa(
            (origin[:, 0], origin[:, 1], origin[:, 2]),
            (direction[:, 0], direction[:, 1], direction[:, 2]),
            (c[:, 0], c[:, 1], c[:, 2]), (c[:, 3], c[:, 4], c[:, 5]),
            (c[:, 6], c[:, 7], c[:, 8]))
        miss = tri < 0
        u, v, s = (torch.where(miss, 0.0, x) for x in (u, v, s))
        tn = scene.tri_normals[ti]
        n0, n1, n2 = tn[:, 0], tn[:, 1], tn[:, 2]
        tri_n = normalize((n0 + (n1 - n0) * u[:, None] + (n2 - n0)
                           * v[:, None]) * s[:, None], eps=1e-20)
        tri_m = scene.tri_material[ti]
    else:
        tri_n, tri_m, s = sph_n, sph_m, sp_s
    mw = mesh_wins[:, None]
    return Hit(t=t, pos=pos, normal=torch.where(mw, tri_n, sph_n),
               orientation=torch.where(mesh_wins, s, sp_s),
               material=torch.where(mesh_wins, tri_m, sph_m))
