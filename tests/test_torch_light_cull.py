"""The brute tier's light shadow cull (B1e, `csrc/path_common.cuh`
`shadow_tris`) through its plain float32 version,
`megakernel.light_cull_reference`, on the CPU.

A culled triangle skips Möller-Trumbore, which is exact only if it could
not have been hit below the segment's end b = min(far, sphere t -
HIT_EPS, 0.999 dist). So: the brute tier's triangle rows carry the normal
cross(e1, e2) the cull reads (the BVH tier's rows are unchanged); the cull
never removes a triangle that `intersect_tris_brute` hits with HIT_EPS < t
< b, on the shadow segments of the lockstep's light NEE (16x16 frames of
the scenes of `tests/light_nee_cases.py`) and on seeded adversarial
segments (ends within 1e-9 to 1e-3 of a plane, origins 1e-4 off a
triangle, grazing directions; on the Cornell box, the Glow Orbs and
triangles tilted off the axes); the light shadow decision with the culled
triangles skipped equals the closest-hit rule over every triangle on all
of them; the Cornell box culls at least 90% of its triangle tests,
which is the design's premise; and the rows are made once for a scene's
triangle tensors, anew where those change. Exact: no tolerance.
"""

import sys

import numpy as np
import pytest
import torch

from light_nee_cases import SCENES as LIGHT_SCENES
import halogen_tpu_torch as ht
import halogen_tpu_torch.integrator.trace as tr
from halogen_tpu_torch import interop
from halogen_tpu_torch.integrator.intersect import (
    _intersect_spheres,
    intersect_tris_brute,
)
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.scene import cornell

CPU = "cpu"
HIT_EPS = np.float32(1e-4)
VIS_SCALE = np.float32(0.999)
CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
SEGMENT_SCENES = ("cornell", "glow_orbs", "blocked_plate", "glass_box")


def _scene(name):
    make, _ = LIGHT_SCENES[name]
    return interop.scene_from_numpy(interop.scene_to_numpy(make()),
                                    device=CPU)


def _lockstep_segments(name):
    """The light shadow rays the port's lockstep casts on a 16x16 frame of
    light_nee_cases' scene `name` (2 spp, its bounces): the locals of
    `trace.light_nee` where it calls `intersect_scene`, on the lanes that
    cast one (its `cand`). Returns (scene, origin, direction, far, is_tri,
    idx, dist)."""
    scene = _scene(name)
    st = ht.RenderSettings(**{
        "max_bounces": 4, **LIGHT_SCENES[name][1], "width": 16,
        "height": 16, "samples_per_pixel": 2, "ray_chunk_size": 512,
        "light_importance_sampling": True})
    got = []
    isect0 = tr.intersect_scene

    def isect(sc, origin, direction, far, settings):
        f = sys._getframe(1)
        if f.f_code is tr.light_nee.__code__:
            loc = f.f_locals
            c = loc["cand"]
            got.append((origin[c], direction[c], far[c], loc["is_tri"][c],
                        loc["ls"]["idx"][c], loc["dist"][c]))
        return isect0(sc, origin, direction, far, settings)

    tr.intersect_scene = isect
    try:
        ht.render_frame(scene, ht.make_camera(**CAM, device=CPU), st, 1)
    finally:
        tr.intersect_scene = isect0
    assert got, name
    return (scene, *(torch.cat([g[k] for g in got]) for k in range(6)))


def _tri_t(scene, o, d):
    """[N, T] Möller-Trumbore t of every ray against each triangle alone
    (`intersect_tris_brute`; inf where it misses)."""
    verts = scene.tri_verts_world
    return torch.stack([intersect_tris_brute(o, d, verts[j:j + 1])[0]
                        for j in range(scene.num_triangles)], dim=1)


def _closest(t):
    """The first-min closest hit over the columns of t [N, T], as the
    kernel's scan takes it (strict <, in triangle order)."""
    best = torch.full((t.shape[0],), float("inf"))
    arg = torch.full((t.shape[0],), -1, dtype=torch.int64)
    for j in range(t.shape[1]):
        better = t[:, j] < best
        best = torch.where(better, t[:, j], best)
        arg = torch.where(better, j, arg)
    return best, arg


def _decide(scene, o, d, far, is_tri, idx, dist):
    """(the closest-hit rule's decision over every triangle, the decision
    with the culled triangles skipped, culled [N, T], t [N, T], b): the
    kernel's `closest_rule` on both scans (path_common.cuh), in float32."""
    sp_t, sp_i, _ = _intersect_spheres(scene, o, d, far)
    bound = dist * VIS_SCALE
    b = torch.minimum(torch.minimum(far, sp_t - HIT_EPS), bound)
    tab = mk._scene_tables(scene)[0]
    culled = mk.light_cull_reference(tab, o, d, b)
    t = _tri_t(scene, o, d)

    def rule(tr_t, tr_i):
        mesh_wins = (tr_t < sp_t - HIT_EPS) & (tr_t < far)
        own = torch.where(is_tri, mesh_wins & (tr_i == idx),
                          ~mesh_wins & torch.isfinite(sp_t) & (sp_i == idx))
        return own | (torch.where(mesh_wins, tr_t, sp_t) >= bound)

    full = rule(*_closest(t))
    cull = rule(*_closest(torch.where(culled, float("inf"), t)))
    return full, cull, culled, t, b


def _check_exact(scene, o, d, far, is_tri, idx, dist):
    full, cull, culled, t, b = _decide(scene, o, d, far, is_tri, idx, dist)
    hit_below = (t > HIT_EPS) & (t < b[:, None])
    assert not bool((culled & hit_below).any()), (
        f"{int((culled & hit_below).sum())} culled triangles hit below b")
    apart = full != cull
    assert not bool(apart.any()), f"{int(apart.sum())} rays decided apart"
    return culled, hit_below, full


@pytest.mark.parametrize("name", ["cornell", "glow_orbs", "glass_box"])
def test_brute_rows_carry_the_normal(name):
    """The brute tier's triangle rows: v0, e1, e2 as before, then
    cross(e1, e2) of the stored edges, in float64 rounded once."""
    scene = _scene(name)
    assert not mk.uses_bvh(scene)
    tab = mk._scene_tables(scene)[0].numpy()
    tv = scene.tri_verts_world.numpy()
    assert tab.shape == (scene.num_triangles, 12)
    np.testing.assert_array_equal(tab[:, 0:3], tv[:, 0])
    np.testing.assert_array_equal(tab[:, 3:6], tv[:, 1] - tv[:, 0])
    np.testing.assert_array_equal(tab[:, 6:9], tv[:, 2] - tv[:, 0])
    want = np.cross(tab[:, 3:6].astype(np.float64),
                    tab[:, 6:9].astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(tab[:, 9:12], want)
    assert (np.abs(want).sum(axis=1) > 0).all()


def test_bvh_tier_rows_are_unchanged():
    """On the BVH tier the rows are the world BVH's own, their last three
    floats zero."""
    from test_torch_kernel_cuda import _blocked_plate

    scene = _blocked_plate(9).build(device=CPU)
    assert mk.uses_bvh(scene)
    tab = mk._scene_tables(scene)[0]
    assert tab is scene.wbvh.tris
    assert bool((tab[:, 9:12] == 0).all())


@pytest.mark.parametrize("name", SEGMENT_SCENES)
def test_cull_is_exact_on_the_lockstep_segments(name):
    """The light shadow rays of the lockstep's light NEE: no culled
    triangle is hit below b, and the decision with the culled triangles
    skipped is the closest-hit rule's on every ray."""
    scene, o, d, far, is_tri, idx, dist = _lockstep_segments(name)
    culled, hit_below, full = _check_exact(scene, o, d, far, is_tri, idx,
                                           dist)
    assert o.shape[0] > 100
    assert bool(culled.any())
    if name == "blocked_plate":  # the plate blocks some, and is not culled
        assert bool(hit_below.any()) and not bool(full.all())


def test_cornell_culls_most_triangle_tests():
    """The design's premise: a Cornell shadow segment runs inside the box,
    short of the panel, so it crosses no triangle's plane; at least 90% of
    the tests are culled (the rest: segments that graze a plane within the
    margin)."""
    scene, o, d, far, is_tri, idx, dist = _lockstep_segments("cornell")
    _, _, culled, _, _ = _decide(scene, o, d, far, is_tri, idx, dist)
    share = float(culled.float().mean())
    assert share >= 0.9, share


def _adversarial(scene, n, rng):
    """Seeded segments against scene's triangles: ends within 1e-9 to 1e-3
    of a triangle's plane on either side, origins 1e-4 off a triangle
    toward random directions, and directions grazing a plane. Returns
    (origin, direction, far, is_tri, idx, dist) float32 tensors."""
    tv = scene.tri_verts_world.numpy().astype(np.float64)
    n_t = tv.shape[0]
    nrm = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)

    def on_tri(j, spread):  # a point of triangle j's plane, near it
        a, c = rng.uniform(-spread, 1 + spread, (2, len(j)))
        swap = a + c > 1 + spread
        a, c = np.where(swap, 1 - a, a), np.where(swap, 1 - c, c)
        return tv[j, 0] + a[:, None] * (tv[j, 1] - tv[j, 0]) + c[:, None] * (
            tv[j, 2] - tv[j, 0])

    k = n // 3
    j = rng.integers(0, n_t, k)
    side = lambda: rng.choice([-1.0, 1.0], (k, 1))
    off = lambda: 10.0 ** rng.uniform(-9, -3, (k, 1))
    # ends near a plane: the origin near one triangle's plane (or anywhere
    # in the box), the end near it, on either side
    o1 = np.where(rng.random((k, 1)) < 0.5, on_tri(j, 0.2) + side() * off()
                  * nrm[j], rng.uniform(-0.99, 0.99, (k, 3)))
    e1 = on_tri(j, 0.3) + side() * off() * nrm[j]
    # origins 1e-4 off a triangle, random directions
    j2 = rng.integers(0, n_t, k)
    o2 = on_tri(j2, 0.0) + side() * 1e-4 * nrm[j2]
    e2 = o2 + rng.normal(size=(k, 3)) * rng.uniform(0.01, 2.5, (k, 1))
    # grazing: along a plane, 1e-6 to 1e-3 off it, tilted by 1e-7 to 1e-2
    j3 = rng.integers(0, n_t, k)
    tang = np.cross(nrm[j3], rng.normal(size=(k, 3)))
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    o3 = on_tri(j3, 0.5) + side() * 10.0 ** rng.uniform(-6, -3, (k, 1)) * (
        nrm[j3])
    tilt = side() * 10.0 ** rng.uniform(-7, -2, (k, 1))
    e3 = o3 + (tang + tilt * nrm[j3]) * rng.uniform(0.05, 2.5, (k, 1))
    o = np.concatenate([o1, o2, o3])
    e = np.concatenate([e1, e2, e3])
    dv = e - o
    length = np.linalg.norm(dv, axis=1)
    d = dv / length[:, None]
    m = o.shape[0]
    far = np.where(rng.random(m) < 0.8, np.inf, rng.uniform(0.5, 4.0, m))
    lights = scene.lights
    pick = rng.integers(0, lights.count, m)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (f32(o), f32(d), f32(far), lights.kind[pick] == 0,
            lights.idx[pick].to(torch.int64), f32(length / VIS_SCALE))


def _tilted():
    """The Cornell box and its panel with 8 seeded triangles at random
    orientations inside it: planes off the axes, whose normal and
    Möller-Trumbore both round (without a margin the cull fails here)."""
    s = cornell.cornell_box(with_spheres=False)
    v = np.random.default_rng(1).uniform(-0.9, 0.9, (24, 3))
    s.add_mesh(v.astype(np.float32), np.arange(24, dtype=np.int32).reshape(
        8, 3), ht.Material.diffuse((0.5, 0.5, 0.5)))
    return s.build(device=CPU)


@pytest.mark.parametrize("name", ["cornell", "glow_orbs", "tilted"])
def test_cull_is_exact_on_adversarial_segments(name):
    """Seeded segments that end on a plane to within 1e-9 to 1e-3, leave a
    triangle 1e-4 off it or graze a plane: no culled triangle is hit
    below b, the decisions equal the closest-hit rule's, and the set holds
    both culled triangles and hits below b."""
    scene = _tilted() if name == "tilted" else _scene(name)
    rng = np.random.default_rng(0)
    segs = _adversarial(scene, 9000, rng)
    culled, hit_below, _ = _check_exact(scene, *segs)
    assert bool(culled.any()) and bool(hit_below.any())
    assert bool((~culled).any())


def test_brute_rows_are_made_once_per_scene():
    """`_scene_tables` makes the brute tier's triangle tables once for the
    scene's triangle tensors: asked again (a frame, a gradient step, a
    scene with other materials) it returns the same tensors; a scene with
    new vertices, or vertices changed in place, gets tables made anew,
    equal to those a fresh scene gets."""
    import dataclasses

    scene = _scene("cornell")
    tri, trin, _, mat = mk._scene_tables(scene)
    again = mk._scene_tables(scene)
    assert again[0] is tri and again[1] is trin
    other = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, roughness=scene.materials.roughness + 0.1))
    tri_o, trin_o, _, mat_o = mk._scene_tables(other)
    assert tri_o is tri and trin_o is trin
    assert not torch.equal(mat_o, mat)
    moved = dataclasses.replace(
        scene, tri_verts_world=scene.tri_verts_world * 0.5)
    tri_m = mk._scene_tables(moved)[0]
    assert tri_m is not tri
    fresh = _scene("cornell")
    tri_0 = mk._scene_tables(fresh)[0]
    torch.testing.assert_close(tri_0, tri, rtol=0, atol=0)
    fresh.tri_verts_world.mul_(0.5)
    tri_f = mk._scene_tables(fresh)[0]
    assert tri_f is not tri_0
    torch.testing.assert_close(tri_f, tri_m, rtol=0, atol=0)
    assert not torch.equal(tri_f, tri)
    with torch.inference_mode():
        inf = dataclasses.replace(
            scene, tri_verts_world=scene.tri_verts_world.clone())
        tri_i = mk._scene_tables(inf)[0]
        assert mk._scene_tables(inf)[0] is not tri_i
    torch.testing.assert_close(tri_i, tri, rtol=0, atol=0)
