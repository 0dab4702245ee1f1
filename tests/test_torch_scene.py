"""PyTorch port vs JAX package: `Scene.build()` packs the same tensors,
and scenes carry across through `interop` unchanged."""

import dataclasses

import numpy as np
import pytest
import torch

from halogen_tpu.scene import cornell as jcornell
from halogen_tpu_torch import interop
from halogen_tpu_torch.core.types import SceneData
from halogen_tpu_torch.scene import cornell as tcornell

SCENES = {
    "cornell": lambda c: c.cornell_box(),
    "cornell_glossy": lambda c: c.cornell_box(glossy=True),
    "glass_box": lambda c: c.glass_sphere_box(),
}


def _flat(arrays):
    out = {k: v for k, v in arrays.items() if k != "materials"}
    out.update({f"materials.{k}": v for k, v in arrays["materials"].items()})
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_matches_jax(name):
    ref = _flat(interop.scene_to_numpy(SCENES[name](jcornell).build()))
    got = _flat(interop.scene_to_numpy(SCENES[name](tcornell).build()))
    assert sorted(ref) == sorted(got)
    for key in ref:
        r, g = np.asarray(ref[key]), np.asarray(got[key])
        assert r.dtype == g.dtype, key
        np.testing.assert_array_equal(r, g, err_msg=key)


def test_any_transmissive_flags():
    assert not tcornell.cornell_box(glossy=True).build().any_transmissive
    assert tcornell.glass_sphere_box().build().any_transmissive


def test_scene_from_numpy_round_trip():
    src = jcornell.cornell_box(glossy=True).build()
    port = interop.scene_from_numpy(interop.scene_to_numpy(src), "cpu")
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
    """A mesh the JAX build would reorder through its BVH, and envmaps,
    are not ported yet."""
    s = tcornell.Scene()
    v = np.random.default_rng(0).random((8, 3)).astype(np.float32)
    s.add_mesh(v, np.arange(18).reshape(6, 3) % 8, tcornell.Material())
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        s.build()
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tcornell.cornell_box().build(envmap=object())
