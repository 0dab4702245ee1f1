"""The port's HDR/EXR file IO (`halogen_tpu_torch/scene/hdr_io.py`, a copy
of the JAX package's numpy module) against the JAX package's.

The six cases of `tests/test_hdr_io.py` on the port's module (the render
from a 2048-px file cut to a 256-px HDRI, so that it is not slow); files
written by either package read back equal in the other; and the Testing
Scene's outdoors group under a file HDRI, rendered by both packages, with
env NEE and without, per pixel at the sky frames' tolerance
(`tests/test_torch_render.py`: atol = rtol = 1e-5 on all but 1 pixel in
256).
"""

import numpy as np
import jax
import pytest

import halogen_tpu as jht
from halogen_tpu.scene import hdr_io as jhdr
from halogen_tpu.scene import meshes as jmeshes
import halogen_tpu_torch as tht
from halogen_tpu_torch import interop
from halogen_tpu_torch.scene import hdr_io
from halogen_tpu_torch.scene.envmap import Envmap
from halogen_tpu_torch.scene.meshes import outdoors_scene

CPU = "cpu"  # the port builds on the card unless asked for the CPU
OUT_CAM = dict(position=(0.0, 0.6, 7.0), target=(0, -0.4, 0), fov_deg=50)

_j_render = jax.jit(jht.render_frame, static_argnames=("settings",))


@pytest.fixture(scope="module")
def hdri_small():
    return hdr_io.procedural_hdri(256)


def test_procedural_hdri_equals_jax(hdri_small):
    np.testing.assert_array_equal(hdri_small, jhdr.procedural_hdri(256))


def test_exr_roundtrip_zip(tmp_path, hdri_small):
    p = tmp_path / "t.exr"
    hdr_io.write_exr(str(p), hdri_small, compression="zip")
    back = hdr_io.read_exr(str(p))
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, hdri_small)


def test_exr_roundtrip_uncompressed(tmp_path, hdri_small):
    p = tmp_path / "t.exr"
    hdr_io.write_exr(str(p), hdri_small, compression="none")
    np.testing.assert_array_equal(hdr_io.read_exr(str(p)), hdri_small)


def test_hdr_roundtrip_rgbe_quantized(tmp_path, hdri_small):
    p = tmp_path / "t.hdr"
    hdr_io.write_hdr(str(p), hdri_small)
    back = hdr_io.read_hdr(str(p))
    rel = np.abs(back - hdri_small) / np.maximum(hdri_small, 1e-3)
    assert np.quantile(rel, 0.99) < 0.02  # RGBE has ~8-bit mantissas
    assert back.max() > 100.0  # HDR range survives (sun disc >> 1.0)


def test_load_envmap_dispatch(tmp_path, hdri_small):
    for ext, writer in (("exr", hdr_io.write_exr), ("hdr", hdr_io.write_hdr)):
        p = tmp_path / f"sky.{ext}"
        writer(str(p), hdri_small)
        env = hdr_io.load_envmap(str(p), num_mips=3)
        assert isinstance(env, Envmap)
        assert len(env.mips) == 3
        assert env.mips[0].shape == hdri_small.shape
    with pytest.raises(ValueError):
        hdr_io.load_envmap(str(tmp_path / "sky.png"))


def test_exr_stored_raw_chunks_roundtrip(tmp_path):
    """Scanline blocks that do not shrink under deflate are stored raw
    and read back exactly."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((32, 48, 3)).astype(np.float32) * 1e3
    p = tmp_path / "incompressible.exr"
    hdr_io.write_exr(str(p), img)
    np.testing.assert_array_equal(hdr_io.read_exr(str(p)), img)


@pytest.mark.parametrize("fmt", ["exr zip", "exr none", "hdr"])
def test_files_cross_read(tmp_path, fmt, hdri_small):
    """A file either package writes reads back equal in the other."""
    ext, _, comp = fmt.partition(" ")
    for write_pkg, read_pkg in ((hdr_io, jhdr), (jhdr, hdr_io)):
        p = tmp_path / f"{write_pkg.__name__}.{ext}"
        if ext == "exr":
            write_pkg.write_exr(str(p), hdri_small, compression=comp)
            a, b = read_pkg.read_exr(str(p)), write_pkg.read_exr(str(p))
        else:
            write_pkg.write_hdr(str(p), hdri_small)
            a, b = read_pkg.read_hdr(str(p)), write_pkg.read_hdr(str(p))
        np.testing.assert_array_equal(a, b)
    assert (tmp_path / f"{hdr_io.__name__}.{ext}").read_bytes() == (
        tmp_path / f"{jhdr.__name__}.{ext}").read_bytes()


@pytest.mark.parametrize("env_nee", [False, True])
def test_outdoors_under_a_file_hdri_matches_jax(tmp_path, env_nee):
    """The outdoors group (a ground plane and five spheres, one of glass)
    lit by an HDRI loaded from an EXR file: the port's frame against the
    JAX package's on the same file."""
    p = tmp_path / "sky.exr"
    hdr_io.write_exr(str(p), hdr_io.procedural_hdri(256))
    js = jmeshes.outdoors_scene().build(envmap=jhdr.load_envmap(str(p)))
    ts = outdoors_scene().build(envmap=hdr_io.load_envmap(str(p)),
                                device=CPU)
    ref_scene = interop.scene_to_numpy(js)
    got_scene = interop.scene_to_numpy(ts)
    for a, b in zip(ref_scene["env_mips"], got_scene["env_mips"]):
        np.testing.assert_array_equal(a, b)
    kw = dict(width=16, height=16, samples_per_pixel=2, max_bounces=3,
              ray_chunk_size=512, use_envmap=True,
              env_importance_sampling=env_nee,
              env_mip_level=0 if env_nee else 1)
    ref = np.asarray(_j_render(js, jht.make_camera(**OUT_CAM),
                               jht.RenderSettings(**kw), 1))
    got = tht.render_frame(ts, tht.make_camera(**OUT_CAM, device=CPU),
                           tht.RenderSettings(**kw), 1).numpy()
    assert np.isfinite(got).all() and got.max() > 0.05  # sky-lit
    bad = (np.abs(got - ref) > 1e-5 + 1e-5 * np.abs(ref)).any(axis=-1)
    assert bad.sum() <= max(1, bad.size // 256), (
        f"{bad.sum()} pixels outside 1e-5; max {np.abs(got - ref).max()}")
