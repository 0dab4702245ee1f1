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

CPU = "cpu"  # the port builds on the card unless asked for the CPU

CAMERAS = {
    "pinhole": dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40),
    "aperture": dict(position=(0.3, 0.2, 3.2), target=(0, 0, 0), fov_deg=40,
                     aperture_deg=2.0, focal_distance=3.2),
}


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_make_camera_matches_jax(name):
    ref = interop.camera_to_numpy(jht.make_camera(**CAMERAS[name]))
    got = interop.camera_to_numpy(t_make_camera(**CAMERAS[name], device=CPU))
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
    tcam = interop.camera_from_numpy(interop.camera_to_numpy(jcam), device=CPU)

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


@pytest.mark.parametrize("sampler", ["SOBOL", "PRNG"])
@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_group_rays_matches_jax(name, sampler):
    """`group_rays` (the plain version of the megakernel's ray prologue)
    for a Morton chunk, a nonzero frame and a nonzero first lane, against
    the JAX package's `generate_rays` on `pixel_seed` and `sample_index`:
    the integers bit for bit, the rays at `test_generate_rays_matches_jax`'s
    1e-6."""
    import halogen_tpu_torch as tht
    from halogen_tpu_torch.integrator.trace import (
        _morton_pixel_order,
        group_rays,
    )

    w, h, spp, frame, lane0, spp_block = 24, 16, 8, 5, 3, 2
    perm, _ = _morton_pixel_order(w, h)
    pix = perm[100:260].astype(np.int64)  # a chunk of the Morton order
    n = pix.shape[0]
    jcam = jht.make_camera(**CAMERAS[name], aspect=w / h)
    tcam = interop.camera_from_numpy(interop.camera_to_numpy(jcam), device=CPU)
    st = tht.RenderSettings(width=w, height=h, samples_per_pixel=spp,
                            sampler=tht.SamplerKind[sampler])
    to, td, tsidx, tseed = group_rays(tcam, st, frame, torch.from_numpy(pix),
                                      lane0, spp_block)

    pixb = np.repeat(pix, spp_block)
    lane = np.tile(np.arange(spp_block), n) + lane0
    jseed = jsob.pixel_seed(jnp.asarray(pixb, jnp.uint32))
    jsidx = jsob.sample_index(jnp.uint32(frame), jnp.asarray(lane, jnp.uint32),
                              spp)
    draw = {"SOBOL": jsob.ld_sample_2d, "PRNG": jsob.prng_sample_2d}[sampler]
    jo, jd = j_generate_rays(jcam, jnp.asarray(pixb % w),
                             jnp.asarray(pixb // w), w, h, st.filter_radius,
                             jsidx, jseed, draw)
    assert to.shape == td.shape == (n * spp_block, 3)
    np.testing.assert_array_equal(np.asarray(jsidx).astype(np.int64),
                                  tsidx.numpy())
    np.testing.assert_array_equal(np.asarray(jseed).astype(np.int64),
                                  tseed.numpy())
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=1e-6, rtol=0)
