"""PyTorch port vs JAX package: camera construction and primary rays.

Tolerance 1e-6: the ray math is the same float32 ops; the 3x3 camera
transforms may sum their three products in another order (an ulp or two).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import halogen_tpu as jht
from halogen_tpu.integrator.camera import generate_rays as j_generate_rays
from halogen_tpu.sampler import sobol as jsob
from halogen_tpu_torch import interop
from halogen_tpu_torch.integrator.camera import (
    generate_rays as t_generate_rays,
    make_camera as t_make_camera,
)
from halogen_tpu_torch.sampler import sobol as tsob

CAMERAS = {
    "pinhole": dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40),
    "aperture": dict(position=(0.3, 0.2, 3.2), target=(0, 0, 0), fov_deg=40,
                     aperture_deg=2.0, focal_distance=3.2),
}


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_make_camera_matches_jax(name):
    ref = interop.camera_to_numpy(jht.make_camera(**CAMERAS[name]))
    got = interop.camera_to_numpy(t_make_camera(**CAMERAS[name]))
    for key in ref:
        np.testing.assert_array_equal(np.asarray(ref[key], np.float32),
                                      got[key], err_msg=key)


@pytest.mark.parametrize("sampler", ["ld_sample_2d", "prng_sample_2d"])
@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_generate_rays_matches_jax(name, sampler):
    w, h, n = 24, 16, 24 * 16 * 3
    rng = np.random.default_rng(5)
    pix = rng.integers(0, w * h, n).astype(np.int32)
    sidx = rng.integers(0, 1 << 20, n).astype(np.uint32)
    jcam = jht.make_camera(**CAMERAS[name], aspect=w / h)
    tcam = interop.camera_from_numpy(interop.camera_to_numpy(jcam))

    jo, jd = j_generate_rays(
        jcam, jnp.asarray(pix % w), jnp.asarray(pix // w), w, h, 1.0,
        jnp.asarray(sidx), jsob.pixel_seed(jnp.asarray(pix, jnp.uint32)),
        getattr(jsob, sampler))
    tpix = torch.from_numpy(pix.astype(np.int64))
    to, td = t_generate_rays(
        tcam, tpix % w, tpix // w, w, h, 1.0,
        torch.from_numpy(sidx.astype(np.int64)), tsob.pixel_seed(tpix),
        getattr(tsob, sampler))
    assert to.dtype == td.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=1e-6, rtol=0)
