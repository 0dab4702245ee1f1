"""The port's light table (`halogen_tpu_torch/scene/lights.py`) against the
JAX package's: the table that `Scene.build` makes, bit for bit, on the
Cornell box (two emissive triangles), the Glow Orbs (four emissive
spheres), the closet (a sphere light inside a 540-triangle mesh) and a
dragon scene without emitters; `sample_light` and `sphere_cone_pdf` on
seeded numpy inputs; and the megakernel's packing of the table
(`megakernel.light_table`) decoded back, with a numpy model of the
kernel's binary search, on both tiers."""

import numpy as np
import jax.numpy as jnp
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)
import torch

from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene import meshes as jmeshes
from halogen_tpu.scene.lights import sample_light as j_sample_light
from halogen_tpu.scene.lights import sphere_cone_pdf as j_sphere_cone_pdf
from halogen_tpu_torch import interop
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.scene import cornell as tcornell
from halogen_tpu_torch.scene import meshes as tmeshes
from halogen_tpu_torch.scene.lights import (
    LightTable,
    sample_light,
    select_light,
    sphere_cone_pdf,
)

CPU = "cpu"

SCENES = {  # name -> builder of a `Scene` from either package's modules
    "cornell": lambda c, m: c.cornell_box(),
    "glow_orbs": lambda c, m: c.glow_orbs(),
    "closet": lambda c, m: m.closet_scene(),
    "dragons_hero_320": lambda c, m: m.dragons_hero_scene(1, tris=320),
}
LIGHT_KEYS = ["tri_light_pdf_area", "sphere_light_sel"] + [
    f"lights.{f}" for f in LightTable._fields]


def _scenes(name):
    make = SCENES[name]
    return (make(jcornell, jmeshes).build(),
            make(tcornell, tmeshes).build(device=CPU))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_light_table_matches_jax(name):
    jscene, tscene = _scenes(name)
    ref, got = interop.scene_to_numpy(jscene), interop.scene_to_numpy(tscene)
    assert (jscene.lights is None) == (tscene.lights is None)
    for key in LIGHT_KEYS:
        if key.startswith("lights.") and jscene.lights is None:
            assert key not in got
            continue
        r, g = np.asarray(ref[key]), got[key]
        assert r.dtype == g.dtype, key
        np.testing.assert_array_equal(r, g, err_msg=key)
    expect = {"cornell": (2, 0), "glow_orbs": (0, 4), "closet": (0, 1),
              "dragons_hero_320": None}[name]
    if expect is None:
        assert tscene.lights is None
    else:
        kinds = tscene.lights.kind.numpy()
        assert ((kinds == 0).sum(), (kinds == 1).sum()) == expect


def _random_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.random((3, n), dtype=np.float32)
    u[0, :4] = [0.0, 1.0, 0.5, np.float32(0.99999994)]  # the CDF's edges
    return u


@pytest.mark.parametrize("name", ["cornell", "glow_orbs", "closet"])
def test_sample_light_matches_jax(name):
    jscene, tscene = _scenes(name)
    u_sel, u1, u2 = _random_inputs(4096)
    ref = j_sample_light(jscene.lights, jscene, jnp.asarray(u_sel),
                         jnp.asarray(u1), jnp.asarray(u2))
    got = sample_light(tscene.lights, tscene, torch.from_numpy(u_sel),
                       torch.from_numpy(u1), torch.from_numpy(u2))
    assert sorted(ref) == sorted(got)
    # points, normals and radii of unit scale: a sum of three products
    # that cancels near 0 (as XLA and torch round it) differs by an ulp of
    # its terms, ~1e-7
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    for key in ("kind", "idx"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))


def test_sphere_cone_pdf_matches_jax():
    rng = np.random.default_rng(1)
    n = 4096
    sel = rng.random(n, dtype=np.float32)
    center = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    radius = rng.uniform(0.01, 0.5, n).astype(np.float32)
    point = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    point[:8] = center[:8]  # inside: pdf 0
    ref = np.asarray(j_sphere_cone_pdf(*(jnp.asarray(a) for a in (
        sel, center, radius, point))))
    got = sphere_cone_pdf(*(torch.from_numpy(a) for a in (
        sel, center, radius, point))).numpy()
    assert (got[:8] == 0).all() and (got > 0).sum() > n // 2
    # 1 - cos_max cancels where the cone is narrow: an ulp of |d|^2 (XLA
    # and torch sum its three squares in other orders) moves the pdf by
    # ~1.2e-7 / sin^2 of itself; held at four such ulps
    sin2 = radius ** 2 / np.maximum(((center - point) ** 2).sum(axis=1),
                                    1e-12)
    bound = 5e-7 / np.minimum(sin2, 1.0) * np.abs(ref)
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()


def _kernel_search(cdf: np.ndarray, u: np.ndarray) -> np.ndarray:
    """The megakernel's binary search (csrc/path_common.cuh `light_nee`),
    lane by lane: the first row with cdf >= u, clipped to the last."""
    out = np.empty(u.shape, np.int64)
    for i, x in enumerate(u):
        lo, hi = 0, len(cdf)
        while lo < hi:
            mid = (lo + hi) >> 1
            if cdf[mid] < x:
                lo = mid + 1
            else:
                hi = mid
        out[i] = min(lo, len(cdf) - 1)
    return out


@pytest.mark.parametrize("name", ["cornell", "glow_orbs", "closet",
                                  "dragon_lit"])
def test_kernel_light_table_decodes_to_the_scene(name):
    """Each row of `megakernel.light_table` holds its light's CDF entry,
    selection probability, pdf_area, the triangle's index in the kernel's
    triangle order (the world BVH's slot on the BVH tier) or -1 - the
    sphere's, the premultiplied emission and the geometry; `dens` the
    per-triangle pdfs in the same order and the spheres' selection
    probabilities. The kernel's search picks the rows `searchsorted`
    does."""
    if name == "dragon_lit":  # an emissive dragon over the brute tier
        s = tcornell.cornell_box(with_spheres=False)
        v, f = tmeshes.dragon_mesh(2)
        s.add_mesh(v, f, tcornell.Material.emissive((1.0, 0.5, 0.2), 3.0),
                   transform=tmeshes._scale_translate(0.4, (0, -0.5, 0)))
        scene = s.build(device=CPU)
        assert mk.uses_bvh(scene)
    else:
        scene = _scenes(name)[1]
    lt = scene.lights
    rows, dens = mk.light_table(scene)
    n_t, n_s = scene.num_triangles, scene.num_spheres
    assert rows.shape == (lt.count, 16) and dens.shape == (n_t + n_s,)
    assert torch.equal(rows[:, 0], lt.cdf) and torch.equal(rows[:, 1], lt.sel)
    assert torch.equal(rows[:, 2], lt.pdf_area)
    code = rows[:, 3].to(torch.int64)
    is_tri = code >= 0
    assert torch.equal(is_tri, lt.kind == 0)
    tri_order = (scene.wbvh.tri_map.to(torch.int64) if mk.uses_bvh(scene)
                 else torch.arange(n_t))
    idx = torch.where(is_tri, tri_order[torch.clamp_min(code, 0)], -1 - code)
    assert torch.equal(idx, lt.idx.to(torch.int64))
    mats = scene.materials
    for i in range(lt.count):
        j = int(idx[i])
        if is_tri[i]:
            m = int(scene.tri_material[j])
            assert torch.equal(rows[i, 7:16],
                               scene.tri_verts_world[j].reshape(9))
        else:
            m = int(scene.sphere_material[j])
            assert torch.equal(rows[i, 7:10], scene.sphere_center[j])
            assert float(rows[i, 10]) == float(scene.sphere_radius[j])
        assert torch.equal(rows[i, 4:7],
                           mats.emissive[m, :3] * mats.emissive[m, 3])
    assert torch.equal(dens[:n_t], scene.tri_light_pdf_area[:n_t][tri_order])
    assert torch.equal(dens[n_t:], scene.sphere_light_sel[:n_s])
    u = _random_inputs(2048)[0]
    np.testing.assert_array_equal(
        _kernel_search(rows[:, 0].numpy(), u),
        select_light(lt, torch.from_numpy(u)).numpy())
