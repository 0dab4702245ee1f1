"""PyTorch port vs JAX package: `Scene.build()` packs the same tensors
(triangle tables, per-mesh BVHs, offsets, materials, and a world BVH with
the JAX package's tree and slots), scenes carry across through `interop`
unchanged, and the public entry points build on the card unless the
caller asks for the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from halogen_tpu.kernels.bvh_pallas import pack_world_bvh as j_pack_world_bvh
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene import meshes as jmeshes
from halogen_tpu.scene import testing_scene as jtesting
from halogen_tpu_torch import interop
from halogen_tpu_torch.core.types import SceneData
from halogen_tpu_torch.scene import cornell as tcornell
from halogen_tpu_torch.scene import meshes as tmeshes
from halogen_tpu_torch.scene import testing_scene as ttesting

CPU = "cpu"  # every test here builds on the CPU

SCENES = {
    "cornell": lambda c: c.cornell_box(),
    "cornell_glossy": lambda c: c.cornell_box(glossy=True),
    "glass_box": lambda c: c.glass_sphere_box(),
}
BIG_SCENES = {  # (JAX module, port module, builder)
    "glass_dragon": (jmeshes, tmeshes, lambda m: m.glass_dragon_scene()),
    "testing_active": (jtesting, ttesting,
                       lambda m: m.testing_scene(False)),
}


def _flat(arrays):
    out = {k: v for k, v in arrays.items() if k != "materials"}
    out.update({f"materials.{k}": v for k, v in arrays["materials"].items()})
    return out


def _assert_same(ref, got):
    assert sorted(ref) == sorted(got)
    for key in ref:
        r, g = np.asarray(ref[key]), np.asarray(got[key])
        assert r.dtype == g.dtype, key
        np.testing.assert_array_equal(r, g, err_msg=key)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_matches_jax(name):
    ref = _flat(interop.scene_to_numpy(SCENES[name](jcornell).build()))
    got = _flat(interop.scene_to_numpy(
        SCENES[name](tcornell).build(device=CPU)))
    _assert_same(ref, got)


@pytest.mark.parametrize("name", sorted(BIG_SCENES))
def test_big_scene_build_matches_jax(name):
    """Meshes over 5 triangles: per-mesh BVHs reorder the triangles as the
    JAX build does (the JAX side skips its TPU packers), and the world
    BVH's nodes, slot-order tables and tri_map are the tree that the JAX
    package's `pack_world_bvh` builds from the same world triangles."""
    jmod, tmod, make = BIG_SCENES[name]
    jscene = make(jmod).build(world_bvh=False)
    tscene = make(tmod).build(device=CPU)
    _assert_same(_flat(interop.scene_to_numpy(jscene)),
                 _flat(interop.scene_to_numpy(tscene)))

    tv = np.asarray(jscene.tri_verts_world)
    ref = j_pack_world_bvh(tv)
    w = tscene.wbvh
    nn = w.num_nodes
    flat = np.asarray(ref.nodes).reshape(-1, 8)  # padded ids, from 1
    np.testing.assert_array_equal(w.nodes.numpy(), flat[1:nn + 1])
    assert not flat[nn + 1:].any()
    t = tv.shape[0]
    np.testing.assert_array_equal(w.tri_map.numpy(),
                                  np.asarray(ref.tri_map)[:t])
    np.testing.assert_array_equal(w.tris.numpy(),
                                  np.asarray(ref.tris)[:9, :t].T)
    order = w.tri_map.numpy()
    n = np.asarray(jscene.tri_normals_world)[order]
    np.testing.assert_array_equal(w.trin[:, 0:3].numpy(), n[:, 0])
    np.testing.assert_array_equal(w.trin[:, 3:6].numpy(), n[:, 1] - n[:, 0])
    np.testing.assert_array_equal(
        w.trin[:, 9].numpy(),
        np.asarray(jscene.tri_material)[order].astype(np.float32))
    # a JAX-built scene reaches the port with the same world BVH
    carried = interop.scene_from_numpy(interop.scene_to_numpy(jscene), CPU)
    for f in ("nodes", "tris", "trin", "tri_map"):
        assert torch.equal(getattr(carried.wbvh, f), getattr(w, f)), f


def test_any_transmissive_flags():
    assert not tcornell.cornell_box(glossy=True).build(
        device=CPU).any_transmissive
    assert tcornell.glass_sphere_box().build(device=CPU).any_transmissive


def test_scene_from_numpy_round_trip():
    src = jcornell.cornell_box(glossy=True).build()
    port = interop.scene_from_numpy(interop.scene_to_numpy(src), CPU)
    assert isinstance(port, SceneData)
    assert port.num_triangles == src.num_triangles == 12
    assert port.num_spheres == src.num_spheres == 2
    assert port.materials.count == src.materials.count == 5
    back = _flat(interop.scene_to_numpy(port))
    for key, v in _flat(interop.scene_to_numpy(src)).items():
        np.testing.assert_array_equal(np.asarray(v), back[key], err_msg=key)
    moved = port.to("cpu")
    for f in dataclasses.fields(SceneData):
        a, b = getattr(port, f.name), getattr(moved, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_out_of_slice_raises():
    """A mesh over 5 triangles now builds (its BVH reorders it), always
    with its world BVH, so a world-BVH intersector finds BRUTE's hits; a
    scene without triangles has no world BVH and no triangle to hit;
    anything but an `Envmap` is refused."""
    import halogen_tpu_torch as ht
    from halogen_tpu_torch.integrator.intersect import intersect_scene

    s = tcornell.Scene()
    v = np.random.default_rng(0).random((8, 3)).astype(np.float32)
    s.add_mesh(v, np.arange(18).reshape(6, 3) % 8, tcornell.Material())
    built = s.build(device=CPU)
    assert built.num_triangles == 6 and built.wbvh is not None
    c = torch.from_numpy(v[:3].mean(axis=0))  # the first triangle's centre
    o = torch.stack([c - torch.tensor([0.0, 0, 2]),
                     torch.tensor([0.0, 0, -2])])
    d = torch.tensor([[0.0, 0, 1], [0.0, 0, -1]])
    far = torch.full((2,), 10.0)
    hits = [intersect_scene(built, o, d, far, ht.RenderSettings(
        intersector=kind)) for kind in (ht.Intersector.BRUTE,
                                        ht.Intersector.RAYLET)]
    assert bool((hits[0].tri >= 0).any())
    for f in dataclasses.fields(hits[0]):
        assert torch.equal(getattr(hits[0], f.name), getattr(hits[1], f.name))
    empty = tcornell.Scene()
    empty.add_sphere((0.0, 0.0, 0.0), 0.5, tcornell.Material())
    bare = empty.build(device=CPU)
    assert bare.num_triangles == 0 and bare.wbvh is None
    hit = intersect_scene(bare, o, d, far, ht.RenderSettings(
        intersector=ht.Intersector.RAYLET))
    assert bool(hit.t[1] == float("inf")) and int(hit.sphere[1]) == -1
    with pytest.raises(TypeError, match="Envmap"):
        tcornell.cornell_box().build(envmap=object(), device=CPU)


def test_entry_points_default_to_the_card():
    """Without a device, `Scene.build`, `make_camera`, `RenderState.create`,
    `interop`'s builders, `build_env_cdf` and `testing_scene_camera` build
    on the card; on a machine without one they raise instead of building
    on the CPU. Where there is a card, they land on it."""
    import halogen_tpu_torch as ht
    from halogen_tpu_torch.scene.envmap import build_env_cdf

    src = jcornell.cornell_box().build()
    arrays = interop.scene_to_numpy(src)
    cam = interop.camera_to_numpy(ht.make_camera(device=CPU))
    env = ht.Envmap.gradient_sky().mips[0]
    calls = {
        "Scene.build": lambda: tcornell.cornell_box().build().device,
        "make_camera": lambda: ht.make_camera().far.device,
        "RenderState.create": lambda: ht.RenderState.create(
            ht.RenderSettings(width=4, height=4)).accum.device,
        "scene_from_numpy": lambda: interop.scene_from_numpy(arrays).device,
        "camera_from_numpy": lambda: interop.camera_from_numpy(
            cam).far.device,
        "build_env_cdf": lambda: build_env_cdf(env).pdf.device,
        "testing_scene_camera": lambda: ttesting.testing_scene_camera(
            ).far.device,
    }
    for name, call in calls.items():
        if torch.cuda.is_available():
            assert call().type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
