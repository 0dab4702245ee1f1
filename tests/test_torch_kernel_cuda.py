"""The CUDA megakernel vs its plain PyTorch version on the card.

Needs an NVIDIA GPU with nvcc; skips without one. Imports no JAX, so it
also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_kernel_cuda.py -q

Tolerance: the kernel is built with -fmad=false and follows the Pallas
body op for op, the plain version the lockstep integrator; the two differ
in the rounding of a few ops (v * (1/x) vs v / x, sin/cos/exp), which can
flip a rare Russian-roulette or edge decision. So atol = rtol = 1e-4 per
ray, with at most 0.1% of rays outside.
"""

import numpy as np
import pytest
import torch

import halogen_tpu_torch as ht
from halogen_tpu_torch.integrator.camera import generate_rays
from halogen_tpu_torch.integrator.trace import _sampler_2d
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.sampler import sobol as sob
from halogen_tpu_torch.scene import cornell

CASES = {
    "sobol_rr": dict(max_bounces=4),
    "sobol_no_rr": dict(max_bounces=4, russian_roulette=False),
    "prng_rr": dict(max_bounces=4, sampler=ht.SamplerKind.PRNG),
    "bounce_limits": dict(max_bounces=6, max_diffuse_bounces=1,
                          max_glossy_bounces=2, russian_roulette=False),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case, cuda_device):
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                           **CASES[case])
    scene = cornell.cornell_box(glossy=True).build(device=cuda_device)
    cam = ht.make_camera(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40,
                         device=cuda_device)
    pix = torch.arange(st.num_pixels, device=cuda_device).repeat_interleave(2)
    lane = torch.arange(2, device=cuda_device).repeat(st.num_pixels)
    sidx = sob.sample_index(1, lane, st.samples_per_pixel)
    seed = sob.pixel_seed(pix)
    o, d = generate_rays(cam, pix % st.width, pix // st.width, st.width,
                         st.height, st.filter_radius, sidx, seed,
                         _sampler_2d(st))
    before = mk.LAUNCHES
    got = mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st)
    assert mk.LAUNCHES == before + 1
    ref = mk.trace_color_fused_reference(scene, o, d, cam.far, sidx, seed, st)
    torch.cuda.synchronize()
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert got.shape == (pix.shape[0], mk.N_OUTPUTS)
    assert np.isfinite(got).all()
    bad = (np.abs(got - ref) > 1e-4 + 1e-4 * np.abs(ref)).any(axis=1)
    assert bad.sum() <= max(1, got.shape[0] // 1000)


@pytest.mark.cuda
def test_render_frame_launches_kernel(cuda_device):
    """render_frame on a CUDA scene goes through the kernel: one launch
    per spp group, and the frame agrees with the plain version's (at most
    one pixel outside 1e-4, for the reason above)."""
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=4,
                           max_bounces=4, ray_chunk_size=2048)
    scene = cornell.cornell_box(glossy=True).build(device=cuda_device)
    cam = ht.make_camera(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40,
                         device=cuda_device)
    before = mk.LAUNCHES
    img = ht.render_frame(scene, cam, st, 1)
    assert mk.LAUNCHES - before == 2  # 1024 pixels x 2 lanes per launch
    plain = ht.render_frame(scene, cam, st.replace(fused=ht.Fused.OFF), 1)
    assert mk.LAUNCHES - before == 2
    img, plain = img.cpu().numpy(), plain.cpu().numpy()
    bad = (np.abs(img - plain) > 1e-4 + 1e-4 * np.abs(plain)).any(axis=-1)
    assert bad.sum() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("fused", ["AUTO", "FORCE"])
def test_scene_over_kernel_caps_raises_on_card(fused, cuda_device):
    """A CUDA scene over the kernel's caps (36 spheres > MAX_SPHERES) is
    refused, not rendered by the plain version on the card."""
    st = ht.RenderSettings(width=8, height=8, samples_per_pixel=2,
                           max_bounces=2, fused=ht.Fused[fused])
    scene = cornell.material_demo_spheres(rows=6, cols=6).build(
        device=cuda_device)
    assert scene.num_spheres > mk.MAX_SPHERES
    cam = ht.make_camera(position=(0, 2, 6), target=(0, 0.5, -3),
                         fov_deg=50, device=cuda_device)
    before = mk.LAUNCHES
    with pytest.raises(NotImplementedError, match="ROADMAP A8, A9"):
        ht.render_frame(scene, cam, st, 1)
    assert mk.LAUNCHES == before
