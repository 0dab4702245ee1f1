"""Brute-force scene intersection (PyTorch port of the BRUTE tier of
`halogen_tpu/integrator/intersect.py`; reference
`HalgoenCompute.compute:244-485`).

Rays are tested against every world-space triangle and every sphere at
once ([T, N] and [S, N] tensors); the closest hit keeps the first minimum
on ties, and a mesh hit must beat the sphere hit by HIT_EPS and lie inside
the far plane (compute:452).
"""

from __future__ import annotations

import torch

from halogen_tpu_torch.config import Intersector, RenderSettings
from halogen_tpu_torch.core.math import (
    HIT_EPS,
    INF,
    normalize,
    ray_aabb_soa,
    sphere_intersect_soa,
    triangle_intersect_soa,
)
from halogen_tpu_torch.core.types import HitRecord, SceneData


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/dir with zero components clamped so the slab test stays NaN-free."""
    tiny = 1e-30
    return 1.0 / torch.where(torch.abs(d) < tiny, tiny, d)


def intersect_tris_brute(origin: torch.Tensor, direction: torch.Tensor,
                         tri_verts: torch.Tensor):
    """Closest hit over all triangles.

    Returns (t [N], tri_index [N], u [N], v [N], orientation [N]); misses
    have t = +inf and u = v = orientation = 0.
    """
    n = origin.shape[0]
    if tri_verts.shape[0] == 0:
        z = origin.new_zeros((n,))
        return (torch.full((n,), INF, device=origin.device),
                torch.zeros((n,), dtype=torch.int64, device=origin.device),
                z, z, z)
    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    comps = torch.cat([v0, e1, e2], dim=1)  # [T, 9]
    rows = comps.T[:, :, None]  # [9, T, 1]

    o = tuple(origin[None, :, k] for k in range(3))  # [1, N]
    d = tuple(direction[None, :, k] for k in range(3))
    t, _, _, _ = triangle_intersect_soa(
        o, d, (rows[0], rows[1], rows[2]), (rows[3], rows[4], rows[5]),
        (rows[6], rows[7], rows[8]))  # [T, N]
    t = torch.where(t > HIT_EPS, t, INF)
    # torch.min returns the index of the first minimum on ties
    best_t, best_i = torch.min(t, dim=0)

    # (u, v, orientation) of the winning triangle: one [N] Möller-Trumbore
    win = comps[best_i]  # [N, 9]
    _, best_u, best_v, best_s = triangle_intersect_soa(
        (origin[:, 0], origin[:, 1], origin[:, 2]),
        (direction[:, 0], direction[:, 1], direction[:, 2]),
        (win[:, 0], win[:, 1], win[:, 2]),
        (win[:, 3], win[:, 4], win[:, 5]),
        (win[:, 6], win[:, 7], win[:, 8]),
    )
    miss = best_t >= INF
    best_u = torch.where(miss, 0.0, best_u)
    best_v = torch.where(miss, 0.0, best_v)
    best_s = torch.where(miss, 0.0, best_s)
    return best_t, best_i, best_u, best_v, best_s


def _intersect_spheres(scene: SceneData, origin, direction, far):
    """Sphere pass (get_ray_scene_intersection_sphere, compute:357-376):
    AABB pre-test against the far plane, then the quadratic, keeping the
    closest t > HIT_EPS."""
    n = origin.shape[0]
    if scene.num_spheres == 0:
        return (torch.full((n,), INF, device=origin.device),
                torch.zeros((n,), dtype=torch.int64, device=origin.device),
                torch.ones((n,), device=origin.device))
    o = tuple(origin[None, :, k] for k in range(3))  # [1, N]
    d = tuple(direction[None, :, k] for k in range(3))
    inv_dv = _safe_inv(direction)
    inv_d = tuple(inv_dv[None, :, k] for k in range(3))
    c = tuple(scene.sphere_center[:, k][:, None] for k in range(3))  # [S, 1]
    r = scene.sphere_radius[:, None]
    lo = tuple(ck - r for ck in c)
    hi = tuple(ck + r for ck in c)
    aabb_t = ray_aabb_soa(lo, hi, o, inv_d)  # [S, N]
    t, orient = sphere_intersect_soa(o, d, c, r)
    t = torch.where((aabb_t < far[None, :]) & (t > HIT_EPS), t, INF)
    best_t, arg = torch.min(t, dim=0)
    best_orient = orient.gather(0, arg[None, :])[0]
    return best_t, arg, best_orient


def _hit_pos(origin, direction, t):
    """origin + direction * t with miss lanes (t = inf) pinned to the
    origin."""
    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    return origin + direction * t_safe[..., None]


def _sphere_normal_material(scene, pos, sp_i, sp_orient):
    if scene.num_spheres == 0:
        return torch.zeros_like(pos), torch.zeros_like(sp_i)
    normal = normalize(
        (pos - scene.sphere_center[sp_i]) * sp_orient[:, None], eps=1e-20)
    return normal, scene.sphere_material[sp_i].to(torch.int64)


def intersect_brute(scene: SceneData, origin: torch.Tensor,
                    direction: torch.Tensor, far: torch.Tensor) -> HitRecord:
    """Full-scene brute-force closest hit."""
    sp_t, sp_i, sp_orient = _intersect_spheres(scene, origin, direction, far)
    if scene.num_triangles == 0:
        pos = _hit_pos(origin, direction, sp_t)
        normal, material = _sphere_normal_material(scene, pos, sp_i, sp_orient)
        return HitRecord(t=sp_t, pos=pos, normal=normal,
                         orientation=sp_orient, material=material,
                         tri=torch.full_like(sp_i, -1),
                         sphere=torch.where(sp_t < INF, sp_i, -1))

    tr_t, tr_i, tr_u, tr_v, tr_s = intersect_tris_brute(
        origin, direction, scene.tri_verts_world)
    # Mesh hit must beat the sphere hit by epsilon and lie inside the far
    # plane (compute:452).
    mesh_wins = (tr_t < sp_t - HIT_EPS) & (tr_t < far)
    t = torch.where(mesh_wins, tr_t, sp_t)
    pos = _hit_pos(origin, direction, t)

    # Triangle shading normal (compute:462-467), world-space inputs
    tri_n = scene.tri_normals_world[tr_i]  # [N, 3, 3]
    n0, n1, n2 = tri_n[:, 0], tri_n[:, 1], tri_n[:, 2]
    tri_normal = n0 + (n1 - n0) * tr_u[:, None] + (n2 - n0) * tr_v[:, None]
    tri_normal = normalize(tri_normal * tr_s[:, None], eps=1e-20)

    sph_normal, sph_material = _sphere_normal_material(
        scene, pos, sp_i, sp_orient)
    normal = torch.where(mesh_wins[:, None], tri_normal, sph_normal)
    orientation = torch.where(mesh_wins, tr_s, sp_orient)
    material = torch.where(mesh_wins, scene.tri_material[tr_i].to(torch.int64),
                           sph_material)
    return HitRecord(t=t, pos=pos, normal=normal, orientation=orientation,
                     material=material,
                     tri=torch.where(mesh_wins, tr_i, -1),
                     sphere=torch.where((~mesh_wins) & (sp_t < INF), sp_i, -1))


def intersect_scene(scene: SceneData, origin, direction, far,
                    settings: RenderSettings) -> HitRecord:
    """Dispatch on `settings.intersector`; the port has the BRUTE tier."""
    if settings.intersector not in (Intersector.AUTO, Intersector.BRUTE):
        raise NotImplementedError(
            f"intersector {settings.intersector.name} needs BVH traversal, "
            "which is not ported yet (ROADMAP A9)")
    return intersect_brute(scene, origin, direction, far)
