"""Scene intersection (PyTorch port of `halogen_tpu/integrator/intersect.py`;
reference `HalgoenCompute.compute:244-485`).

Three routes, picked by `intersect_scene` from `settings.intersector`:

- **BRUTE** (`intersect_brute`): rays against every world-space triangle
  and every sphere at once ([T, N] and [S, N] tensors, in chunks of rays);
  the closest hit keeps the first minimum on ties.
- **BVH** (`intersect_bvh`): the JAX package's lockstep walk of each
  mesh's own BVH in local space with unnormalized rays, per-ray 32-deep
  stacks, near child first (compute:378-472); the CPU's route for scenes
  over `brute_force_max_tris`.
- **the world BVH** (`intersect_world`): one closest-hit walk over the
  scene's world BVH (`kernels/traverse.py`, B3), seeded with the sphere
  hit. PALLAS, TREELET, FLATLET and RAYLET all name it: on the TPU they
  were four kernels for one contract, on the card they are one kernel
  (its plain version on the CPU). AUTO takes it on the card.

In every route a mesh hit must beat the sphere hit by HIT_EPS and lie
inside the far plane (compute:452). The JAX package's Morton ray sort
before the TPU kernel restored block coherence for its shared stack; a
thread walks alone here and the image does not depend on the order, so
it is not ported.
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
    transform_dir,
    transform_point,
    triangle_intersect_soa,
)
from halogen_tpu_torch.core.types import HitRecord, SceneData

STACK_DEPTH = 32  # NodeStack[32] (HalgoenCompute.compute:397)
_BRUTE_PAIRS = 1 << 24  # ray-triangle pairs per chunk of the brute force


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/dir with zero components clamped so the slab test stays NaN-free."""
    tiny = 1e-30
    return 1.0 / torch.where(torch.abs(d) < tiny, tiny, d)


def closest_tris(origin: torch.Tensor, direction: torch.Tensor,
                 comps: torch.Tensor, seed: torch.Tensor | None = None):
    """Closest hit over every triangle of comps [T, 9] (v0, e1, e2), in
    chunks of rays of at most _BRUTE_PAIRS ray-triangle pairs: a hit needs
    HIT_EPS < t (and t < seed [N] when a seed is given); the first minimum
    in triangle order wins a tie.

    Returns (t [N], tri_index [N], u [N], v [N], orientation [N]); misses
    have t = +inf, tri_index = 0 and u = v = orientation = 0.
    """
    n = origin.shape[0]
    rows = comps.T[:, :, None]  # [9, T, 1]
    chunk = max(1, _BRUTE_PAIRS // max(comps.shape[0], 1))
    best = []
    for c0 in range(0, n, chunk):
        sl = slice(c0, c0 + chunk)
        o = tuple(origin[None, sl, k] for k in range(3))  # [1, n]
        d = tuple(direction[None, sl, k] for k in range(3))
        t, _, _, _ = triangle_intersect_soa(
            o, d, (rows[0], rows[1], rows[2]), (rows[3], rows[4], rows[5]),
            (rows[6], rows[7], rows[8]))  # [T, n]
        ok = t > HIT_EPS
        if seed is not None:
            ok = ok & (t < seed[None, sl])
        # torch.min returns the index of the first minimum on ties
        best.append(torch.min(torch.where(ok, t, INF), dim=0))
    best_t = torch.cat([b[0] for b in best])
    best_i = torch.cat([b[1] for b in best])

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


def intersect_tris_brute(origin: torch.Tensor, direction: torch.Tensor,
                         tri_verts: torch.Tensor):
    """Closest hit over all triangles [T, 3, 3] (`closest_tris`).

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
    comps = torch.cat([v0, tri_verts[:, 1] - v0, tri_verts[:, 2] - v0],
                      dim=1)  # [T, 9]
    return closest_tris(origin, direction, comps)


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
        return _sphere_only(scene, origin, direction, sp_t, sp_i, sp_orient)
    tr_t, tr_i, tr_u, tr_v, tr_s = intersect_tris_brute(
        origin, direction, scene.tri_verts_world)
    # Mesh hit must beat the sphere hit by epsilon and lie inside the far
    # plane (compute:452).
    mesh_wins = (tr_t < sp_t - HIT_EPS) & (tr_t < far)
    return _mesh_hit(scene, origin, direction, sp_t, sp_i, sp_orient,
                     mesh_wins, tr_t, tr_i, tr_u, tr_v, tr_s)


def _mesh_hit(scene, origin, direction, sp_t, sp_i, sp_orient,
              mesh_wins, t_mesh, tri, u, v, s, tri_normal=None,
              material=None) -> HitRecord:
    """HitRecord of a triangle route: the triangle where `mesh_wins`, else
    the sphere hit. The shading normal is interpolated from the world
    normals (compute:462-467) unless the route gives its own."""
    t = torch.where(mesh_wins, t_mesh, sp_t)
    pos = _hit_pos(origin, direction, t)
    if tri_normal is None:
        tri_n = scene.tri_normals_world[tri]  # [N, 3, 3]
        n0, n1, n2 = tri_n[:, 0], tri_n[:, 1], tri_n[:, 2]
        tri_normal = n0 + (n1 - n0) * u[:, None] + (n2 - n0) * v[:, None]
        tri_normal = normalize(tri_normal * s[:, None], eps=1e-20)
        material = scene.tri_material[tri].to(torch.int64)
    sph_normal, sph_material = _sphere_normal_material(
        scene, pos, sp_i, sp_orient)
    return HitRecord(
        t=t, pos=pos,
        normal=torch.where(mesh_wins[:, None], tri_normal, sph_normal),
        orientation=torch.where(mesh_wins, s, sp_orient),
        material=torch.where(mesh_wins, material, sph_material),
        tri=torch.where(mesh_wins, tri, -1),
        sphere=torch.where((~mesh_wins) & (sp_t < INF), sp_i, -1))


def _sphere_only(scene, origin, direction, sp_t, sp_i, sp_orient):
    pos = _hit_pos(origin, direction, sp_t)
    normal, material = _sphere_normal_material(scene, pos, sp_i, sp_orient)
    return HitRecord(t=sp_t, pos=pos, normal=normal, orientation=sp_orient,
                     material=material, tri=torch.full_like(sp_i, -1),
                     sphere=torch.where(sp_t < INF, sp_i, -1))


def intersect_bvh(scene: SceneData, origin: torch.Tensor,
                  direction: torch.Tensor, far: torch.Tensor,
                  max_leaf: int = 5) -> HitRecord:
    """Per-mesh stack-based BVH traversal (get_ray_scene_intersection_mesh,
    compute:378-472; the JAX `intersect_bvh`): for each mesh, every ray
    walks the mesh's tree in local space with its own 32-deep stack,
    near child first, pruned by the best t so far (seeded with the sphere
    hit). The JAX package steps all rays in lockstep under masks; here
    each step takes only the rays whose stacks are not empty, which gives
    every ray the same operations. A leaf tests at most `max_leaf`
    triangles, as there."""
    n = origin.shape[0]
    dev = origin.device
    far = torch.as_tensor(far, dtype=torch.float32, device=dev).expand(n)
    sp_t, sp_i, sp_orient = _intersect_spheres(scene, origin, direction, far)
    if scene.num_triangles == 0 or scene.num_meshes == 0:
        return _sphere_only(scene, origin, direction, sp_t, sp_i, sp_orient)

    # The running closest t starts at the sphere hit (the reference
    # traverses with closestHit.rayT already holding it)
    best_t = sp_t.clone()
    best_tri = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    best_s = torch.zeros((n,), device=dev)
    best_mesh = torch.zeros((n,), dtype=torch.int64, device=dev)
    tri_off_all = scene.mesh_tri_offset.tolist()
    bvh_off_all = scene.mesh_bvh_offset.tolist()
    bvh_count = scene.bvh_count.to(torch.int64)
    bvh_index_a = scene.bvh_index_a.to(torch.int64)
    tv_local = scene.tri_verts_local
    rng = torch.arange(n, device=dev)

    for mi in range(scene.num_meshes):
        w2l = scene.mesh_world_to_local[mi]
        tri_off, bvh_off = tri_off_all[mi], bvh_off_all[mi]
        # Local-space ray, deliberately unnormalized so t stays world-scale
        # (compute:390-395)
        lo_o = transform_point(w2l, origin)
        lo_d = transform_dir(w2l, direction)
        inv_d = _safe_inv(lo_d)
        stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
        sp = torch.ones((n,), dtype=torch.int64, device=dev)  # root pushed
        live = rng
        while live.numel():
            o = tuple(lo_o[live, k] for k in range(3))
            d = tuple(lo_d[live, k] for k in range(3))
            inv = tuple(inv_d[live, k] for k in range(3))
            st, s_p = stack[live], sp[live] - 1
            node = st.gather(1, s_p[:, None])[:, 0]
            g = bvh_off + node
            count, index_a = bvh_count[g], bvh_index_a[g]
            is_leaf = count > 0

            # ---- leaf: test up to max_leaf triangles (compute:407-421)
            bt, btri = best_t[live], best_tri[live]
            bu, bv, bs = best_u[live], best_v[live], best_s[live]
            bmesh = best_mesh[live]
            for k in range(max_leaf):
                tk = tri_off + index_a + k
                do = is_leaf & (k < count)
                tv = tv_local[torch.where(do, tk, 0)]
                v0 = tv[:, 0]
                e1, e2 = tv[:, 1] - v0, tv[:, 2] - v0
                t, u, v, sg = triangle_intersect_soa(
                    o, d, (v0[:, 0], v0[:, 1], v0[:, 2]),
                    (e1[:, 0], e1[:, 1], e1[:, 2]),
                    (e2[:, 0], e2[:, 1], e2[:, 2]))
                ok = do & (t > HIT_EPS) & (t < bt)
                bt = torch.where(ok, t, bt)
                btri = torch.where(ok, tk, btri)
                bu = torch.where(ok, u, bu)
                bv = torch.where(ok, v, bv)
                bs = torch.where(ok, sg, bs)
                bmesh = torch.where(ok, mi, bmesh)
            best_t[live], best_tri[live] = bt, btri
            best_u[live], best_v[live], best_s[live] = bu, bv, bs
            best_mesh[live] = bmesh

            # ---- inner: ordered near-first descent (compute:422-444)
            is_inner = ~is_leaf
            ca = torch.where(is_inner, bvh_off + index_a, 0)
            cb = torch.where(is_inner, bvh_off + index_a + 1, 0)
            lo_a, hi_a = scene.bvh_lo[ca], scene.bvh_hi[ca]
            lo_b, hi_b = scene.bvh_lo[cb], scene.bvh_hi[cb]
            da = ray_aabb_soa((lo_a[:, 0], lo_a[:, 1], lo_a[:, 2]),
                              (hi_a[:, 0], hi_a[:, 1], hi_a[:, 2]), o, inv)
            db = ray_aabb_soa((lo_b[:, 0], lo_b[:, 1], lo_b[:, 2]),
                              (hi_b[:, 0], hi_b[:, 1], hi_b[:, 2]), o, inv)
            a_first = da <= db  # push far child first so near pops first
            far_node = torch.where(a_first, index_a + 1, index_a)
            near_node = torch.where(a_first, index_a, index_a + 1)
            far_d = torch.maximum(da, db)
            near_d = torch.minimum(da, db)
            rows = torch.arange(live.numel(), device=dev)
            for push_d, push_node in ((far_d, far_node), (near_d, near_node)):
                push = is_inner & (push_d < bt) & (s_p < STACK_DEPTH)
                slot = torch.clamp_max(s_p, STACK_DEPTH - 1)
                st[rows, slot] = torch.where(push, push_node,
                                             st[rows, slot])
                s_p = s_p + push.to(torch.int64)
            stack[live], sp[live] = st, s_p
            live = live[s_p > 0]

    # ---- resolve winner: a triangle must beat the sphere hit by epsilon
    # and lie inside the far plane (compute:452)
    mesh_wins = (best_t < sp_t - HIT_EPS) & (best_t < far)
    tri_n = scene.tri_normals_local[best_tri]
    n0, n1, n2 = tri_n[:, 0], tri_n[:, 1], tri_n[:, 2]
    nrm = n0 + (n1 - n0) * best_u[:, None] + (n2 - n0) * best_v[:, None]
    nrm = nrm * best_s[:, None]
    # by the inverse-transpose of local->world: n' = W2L^T n (compute:467)
    w2l = scene.mesh_world_to_local[best_mesh][:, :3, :3]
    tri_normal = normalize((nrm[:, :, None] * w2l).sum(dim=1), eps=1e-20)
    material = scene.mesh_material[best_mesh].to(torch.int64)
    return _mesh_hit(scene, origin, direction, sp_t, sp_i, sp_orient,
                     mesh_wins, best_t, best_tri, best_u, best_v, best_s,
                     tri_normal, material)


def intersect_world(scene: SceneData, origin: torch.Tensor,
                    direction: torch.Tensor, far: torch.Tensor) -> HitRecord:
    """Closest hit through the world BVH (the JAX `intersect_pallas`,
    `intersect.py:473-556`): the sphere pass, then the B3 walk seeded with
    min(far, sphere t - HIT_EPS), so a triangle it returns beats the
    sphere by HIT_EPS inside far (compute:452)."""
    from halogen_tpu_torch.kernels import traverse

    n = origin.shape[0]
    far = torch.as_tensor(far, dtype=torch.float32,
                          device=origin.device).expand(n)
    sp_t, sp_i, sp_orient = _intersect_spheres(scene, origin, direction, far)
    if scene.num_triangles == 0:
        return _sphere_only(scene, origin, direction, sp_t, sp_i, sp_orient)
    seed = torch.minimum(far, torch.where(sp_t < INF, sp_t - HIT_EPS, INF))
    t, tri, u, v, s, _, _ = traverse.traverse_world(
        scene.wbvh, origin, direction, seed)
    mesh_wins = t < seed  # the walk already enforced t < seed
    return _mesh_hit(scene, origin, direction, sp_t, sp_i, sp_orient,
                     mesh_wins, t, torch.clamp_min(tri, 0).to(torch.int64),
                     u, v, s)


def intersect_scene(scene: SceneData, origin, direction, far,
                    settings: RenderSettings) -> HitRecord:
    """Dispatch on `settings.intersector` (get_ray_intersection,
    compute:474-485; the JAX `intersect_scene`): AUTO is BRUTE up to
    `brute_force_max_tris`, above it the world BVH's kernel on the card
    (never the lockstep walk there) and the lockstep BVH walk on the CPU;
    PALLAS, TREELET, FLATLET and RAYLET take the world BVH on every device
    (its kernel on the card, its plain version on the CPU)."""
    kind = settings.intersector
    if kind == Intersector.AUTO:
        if scene.num_triangles <= settings.brute_force_max_tris:
            kind = Intersector.BRUTE
        elif origin.device.type == "cuda":
            kind = Intersector.PALLAS
        else:
            kind = Intersector.BVH
    if kind == Intersector.BRUTE:
        return intersect_brute(scene, origin, direction, far)
    if kind == Intersector.BVH:
        return intersect_bvh(scene, origin, direction, far)
    return intersect_world(scene, origin, direction, far)
