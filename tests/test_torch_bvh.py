"""PyTorch port vs JAX package: the BVH builders (`accel/bvh.py`, the
numpy midpoint builder, and the native binned-SAH builder of
`accel/native_loader.py`) give the same arrays, and the builder's
invariants of `tests/test_bvh.py` hold in the port."""

import numpy as np
import pytest

from halogen_tpu.accel.bvh import build_bvh as j_build_bvh
from halogen_tpu.scene import meshes as jmeshes
from halogen_tpu_torch.accel import bvh_stats, build_bvh, validate_bvh
from halogen_tpu_torch.scene import meshes as tmeshes


def _random_mesh(n_tris=200, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, size=(n_tris, 1, 3))
    offsets = rng.normal(0, 0.3, size=(n_tris, 3, 3))
    return (centers + offsets).astype(np.float32)


def _mesh_tris(name):
    if name == "random":
        return _random_mesh(500)
    if name == "dragon_mesh_2":
        v, f = tmeshes.dragon_mesh(2)
    elif name == "torus_knot_32":
        v, f = tmeshes.torus_knot(segments=32)
    else:
        v, f = tmeshes.real_dragon_mesh()
    return v[f]


@pytest.mark.parametrize("method", ["sah", "midpoint"])
@pytest.mark.parametrize("mesh", ["random", "dragon_mesh_2", "torus_knot_32",
                                  "dragon_8k"])
def test_build_matches_jax(mesh, method):
    """Identical node arrays, triangle order and depth; the port's SAH
    library is built without -march=native, the JAX package's with it."""
    tris = _mesh_tris(mesh)
    ref = j_build_bvh(tris.copy(), method=method)
    got = build_bvh(tris.copy(), method=method)
    for key in ("lo", "hi", "index_a", "count", "tri_order"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key),
                                      err_msg=key)
    assert got.depth == ref.depth
    assert validate_bvh(got, tris[got.tri_order]) == []
    assert bvh_stats(got)["oversized_leaves"] == 0


def test_auto_is_the_native_sah_build():
    tris = _random_mesh(300, seed=2)
    a, s = build_bvh(tris.copy()), build_bvh(tris.copy(), method="sah")
    np.testing.assert_array_equal(a.tri_order, s.tri_order)
    with pytest.raises(ValueError, match="unknown"):
        build_bvh(tris.copy(), method="median")


def test_meshes_match_jax():
    """The procedural meshes and the committed fixtures are the JAX
    package's, and the port's asset files are byte-for-byte its."""
    import pathlib

    for fn in ("dragon_mesh", "torus_knot", "icosphere"):
        for a, b in zip(getattr(jmeshes, fn)(2) if fn != "torus_knot"
                        else jmeshes.torus_knot(segments=32),
                        getattr(tmeshes, fn)(2) if fn != "torus_knot"
                        else tmeshes.torus_knot(segments=32)):
            np.testing.assert_array_equal(a, b)
    for fn in ("real_dragon_mesh", "real_suzanne_mesh", "real_closet_mesh"):
        for a, b in zip(getattr(jmeshes, fn)(), getattr(tmeshes, fn)()):
            np.testing.assert_array_equal(a, b)
    root = pathlib.Path(__file__).resolve().parents[1]
    jdir = root / "halogen_tpu" / "scene" / "assets"
    tdir = root / "halogen_tpu_torch" / "scene" / "assets"
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name


def test_missing_fixture_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tmeshes, "_ASSETS", tmp_path)
    with pytest.raises(FileNotFoundError, match="A12"):
        tmeshes.real_dragon_mesh()


# --- the builder invariants of tests/test_bvh.py, on the port's builder


@pytest.mark.parametrize("method", ["sah", "midpoint"])
def test_invariants_random_mesh(method):
    tris = _random_mesh(500)
    bvh = build_bvh(tris.copy(), method=method)
    assert validate_bvh(bvh, tris[bvh.tri_order]) == []
    assert bvh.count[bvh.count > 0].max() <= 5
    assert bvh.num_nodes > 1


@pytest.mark.parametrize("method", ["sah", "midpoint"])
def test_single_triangle(method):
    tris = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    bvh = build_bvh(tris.copy(), method=method)
    assert bvh.num_nodes == 1
    assert bvh.count[0] == 1


@pytest.mark.parametrize("method", ["sah", "midpoint"])
def test_degenerate_colocated_centroids(method):
    """All centroids identical: the midpoint split fails and the median
    fallback still ends with bounded leaves."""
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    tris = np.repeat(tri, 64, axis=0)
    bvh = build_bvh(tris.copy(), method=method)
    ref = j_build_bvh(tris.copy(), method=method)
    np.testing.assert_array_equal(bvh.tri_order, ref.tri_order)
    assert validate_bvh(bvh, tris[bvh.tri_order]) == []
    assert bvh.count[bvh.count > 0].max() <= 5


@pytest.mark.parametrize("method", ["sah", "midpoint"])
def test_thin_mesh_aabb_epsilon(method):
    """A flat (z = 0) mesh still gets boxes of nonzero thickness."""
    tris = _random_mesh(50)
    tris[..., 2] = 0.0
    bvh = build_bvh(tris.copy(), method=method)
    assert np.all(bvh.hi[:, 2] > bvh.lo[:, 2])
    np.testing.assert_array_equal(
        bvh.hi, j_build_bvh(tris.copy(), method=method).hi)
