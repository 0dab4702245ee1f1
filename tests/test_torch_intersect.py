"""PyTorch port vs JAX package: the big-scene intersection routes.

- `intersect_bvh` (the lockstep per-mesh walk) against the JAX
  `intersect_bvh`, on two dragons (2,562 triangles) and the glass dragon
  (8,724 triangles, an air-bubble sphere inside the glass);
- the world-BVH closest hit's plain version (`kernels/traverse.py`, B3's)
  against the JAX Pallas kernel `traverse_world_bvh_any` in interpret
  mode, as `tests/test_pallas.py` runs it;
- every `Intersector` value of the port against BRUTE.

Rays come from numpy with a seed: 4,096 of them, a quarter aimed at the
scene's spheres, with finite, infinite and negative far planes (a far of
0 or less is a dead lane of the lockstep integrator).

Tolerance: atol = rtol = 1e-5 on t and the normal, with at most 1 ray in
256 outside it (and those within 1e-3), and the same triangle, sphere and
material. Why not every ray: XLA's CPU compiler fuses a * b + c into
FMAs inside the JAX package's jitted Möller-Trumbore, while the port
rounds every op, as its CUDA kernels (built with -fmad=false) do; on a
grazing ray (a small determinant) that moves u and v by up to ~4e-5
(measured on these rays), and the interpolated normal with them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halogen_tpu.integrator import intersect as jint
from halogen_tpu.kernels.bvh_pallas import (
    pack_world_bvh as j_pack_world_bvh,
    traverse_world_bvh_any,
)
from halogen_tpu.scene import meshes as jmeshes
from halogen_tpu_torch import interop
from halogen_tpu_torch.config import Intersector, RenderSettings
from halogen_tpu_torch.core.types import WorldBVH
from halogen_tpu_torch.integrator import intersect as tint
from halogen_tpu_torch.kernels import traverse
from halogen_tpu_torch.scene import meshes as tmeshes
from halogen_tpu_torch.scene.scene import pack_world_bvh

TOL = 1e-5
SCENES = {
    "dragons_2": lambda m: m.dragons_hero_scene(2, tris=1280),
    "glass_dragon": lambda m: m.glass_dragon_scene(),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scenes(request):
    jscene = SCENES[request.param](jmeshes).build(world_bvh=False)
    tscene = interop.scene_from_numpy(interop.scene_to_numpy(jscene), "cpu")
    return request.param, jscene, tscene


def _rays(scene, n=4096, seed=0):
    """Origins around the scene, aimed at random points of its bounds; a
    quarter aimed at sphere centers; far planes mixed."""
    rng = np.random.default_rng(seed)
    tv = scene.tri_verts_world.numpy().reshape(-1, 3)
    lo, hi = tv.min(axis=0), tv.max(axis=0)
    mid, ext = (lo + hi) / 2, (hi - lo) / 2
    o = (mid + rng.uniform(-2.0, 2.0, (n, 3)) * ext).astype(np.float32)
    tgt = mid + rng.uniform(-1.0, 1.0, (n, 3)) * ext
    if scene.num_spheres:
        k = n // 4
        c = scene.sphere_center.numpy()[rng.integers(0, scene.num_spheres, k)]
        tgt[:k] = c + rng.normal(0, 0.05, (k, 3))
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    far = np.full((n,), 1000.0, np.float32)
    far[n // 4:n // 2] = np.inf
    far[-n // 8:] = rng.choice([0.0, -1.0], n // 8)
    far[n // 2:n // 2 + n // 8] = rng.uniform(0.5, 4.0, n // 8)
    return o, d, far


def _hit_arrays(hit):
    to = lambda x: np.asarray(x.detach().numpy() if hasattr(x, "detach")
                              else x)
    return {k: to(getattr(hit, k)) for k in
            ("t", "normal", "material", "tri", "sphere", "orientation")}


def _assert_hits_close(got, ref, max_outside=1 / 256):
    """t and the normal within TOL on all but `max_outside` of the rays,
    and within 1e-3 on every ray; the same triangle, sphere, material and
    orientation on every ray but `max_outside` of them, where t agrees
    within TOL (a tie at an edge two triangles share, resolved the other
    way by an ulp of another space)."""
    both_inf = np.isinf(got["t"]) & np.isinf(ref["t"])
    close = {}
    for tol in (TOL, 1e-3):
        t_ok = both_inf | np.isclose(got["t"], ref["t"], atol=tol, rtol=tol)
        close[tol] = t_ok, t_ok & np.isclose(
            got["normal"], ref["normal"], atol=tol, rtol=tol).all(axis=1)
    n = got["t"].size
    with np.errstate(invalid="ignore"):
        t_diff = np.abs(np.where(both_inf, 0.0, got["t"] - ref["t"]))
    msg = (f"t max |diff| {np.nan_to_num(t_diff).max()}, normal "
           f"{np.abs(got['normal'] - ref['normal']).max()}")
    assert close[1e-3][1].all(), msg
    assert (~close[TOL][1]).sum() <= max_outside * n, msg
    same = np.ones(n, bool)
    for key in ("material", "tri", "sphere", "orientation"):
        same &= got[key] == ref[key]
    assert (~same).sum() <= max_outside * n, f"{(~same).sum()} other hits"
    assert close[TOL][0][~same].all(), "another hit at another t"


def test_intersect_bvh_matches_jax(scenes):
    name, jscene, tscene = scenes
    o, d, far = _rays(tscene)
    ref, _, _ = jint.intersect_bvh(jscene, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(far))
    got = tint.intersect_bvh(tscene, torch.from_numpy(o),
                             torch.from_numpy(d), torch.from_numpy(far))
    ref, got = _hit_arrays(ref), _hit_arrays(got)
    live = far > 0
    assert (got["tri"][live] >= 0).mean() > 0.3, name  # rays hit the mesh
    assert (got["sphere"][live] >= 0).any() or not tscene.num_spheres
    _assert_hits_close(got, ref)


@pytest.fixture(scope="module")
def brute_hits(scenes):
    """2,048 rays of the scene and BRUTE's hits for them."""
    _, _, tscene = scenes
    o, d, far = (torch.from_numpy(a) for a in _rays(tscene, n=2048, seed=1))
    ref = tint.intersect_scene(tscene, o, d, far, RenderSettings(
        intersector=Intersector.BRUTE))
    return o, d, far, _hit_arrays(ref)


@pytest.mark.parametrize("kind", [k for k in Intersector
                                  if k != Intersector.BRUTE])
def test_every_intersector_matches_brute(scenes, brute_hits, kind):
    """AUTO (the lockstep walk on the CPU), BVH and the four world-BVH
    routes give BRUTE's hits; the world routes go through B3's plain
    version on the CPU and count no kernel launch."""
    _, _, tscene = scenes
    o, d, far, ref = brute_hits
    before = traverse.LAUNCHES
    got = tint.intersect_scene(tscene, o, d, far,
                               RenderSettings(intersector=kind))
    assert traverse.LAUNCHES == before
    _assert_hits_close(_hit_arrays(got), ref)


def test_traverse_plain_matches_pallas_interpret():
    """B3's plain version against the JAX shared-stack kernel in interpret
    mode on 1,024 rays over `dragon_mesh(2)`, with seeds 1e30, +inf, a
    sphere-like finite seed and < 0."""
    verts, faces = jmeshes.dragon_mesh(2)
    tv = np.asarray(verts[faces], np.float32)
    rng = np.random.default_rng(0)
    n = 1024
    o = (rng.normal(size=(n, 3)) * 3.0).astype(np.float32)
    tgt = (rng.normal(size=(n, 3)) * 0.4).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    seed = np.full((n,), 1e30, np.float32)
    seed[256:512] = np.inf
    seed[512:768] = rng.uniform(2.0, 4.0, 256)
    seed[768:896] = -1.0
    wb = j_pack_world_bvh(tv)
    ref = [np.asarray(x) for x in traverse_world_bvh_any(
        wb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(seed),
        interpret=True)]
    normals = np.zeros_like(tv)
    w = pack_world_bvh(tv, normals, np.zeros(len(tv), np.int32),
                       device="cpu")
    assert isinstance(w, WorldBVH)
    got = [x.numpy() for x in traverse.traverse_world(
        w, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(seed))]
    t_ref, t_got = ref[0], got[0]
    # The Pallas kernel takes any t > 0; the port's HIT_EPS < t, as the
    # brute tier. No ray here meets a triangle that close.
    assert ((t_ref > 0) & (t_ref <= 1e-4)).sum() == 0
    np.testing.assert_array_equal(np.isinf(t_got), np.isinf(t_ref))
    hit = np.isfinite(t_ref)
    assert 0.3 < hit.mean() < 0.9
    assert not hit[768:896].any()  # negative seeds hit nothing
    np.testing.assert_allclose(t_got[hit], t_ref[hit], atol=TOL, rtol=TOL)
    for i, name in ((1, "tri"), (2, "u"), (3, "v"), (4, "sign")):
        np.testing.assert_allclose(got[i][hit], ref[i][hit], atol=TOL,
                                   rtol=TOL, err_msg=name)
    assert (got[1][~hit] == -1).all()


def test_traverse_world_checks_its_inputs():
    tscene = tmeshes.dragons_hero_scene(1, tris=320).build(device="cpu")
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    with pytest.raises(ValueError, match="no traversal kernel"):
        traverse.traverse_world(tscene.wbvh, o.to("meta"), d.to("meta"),
                                torch.ones(4, device="meta"))
    t, tri, u, v, s, tt, bt = traverse.traverse_world(
        tscene.wbvh, o + torch.tensor([0.0, 0.0, 5.0]), d,
        torch.tensor([1e30, -1.0, 0.0, float("inf")]))
    assert tri[1] == tri[2] == -1 and torch.isinf(t[1:3]).all()
    assert tt[1] == tt[2] == 0 and (bt == 0).all()
