"""The CUDA adjoint kernel vs its plain PyTorch version on the card (B2 on
Cornell glossy, B2b on the glass-in-glass box), and the gradient route
through both kernels.

Needs an NVIDIA GPU with nvcc; skips without one. Imports no JAX, so it
also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_adjoint_cuda.py -q

Tolerance, per column of the [K, 12] table: |kernel - plain| <= 1e-3 *
max |plain column| + 1e-6. The kernel sums each material's cotangents in
another order than autograd's scatter, and up to 0.1% of rays may take
another path than the plain version's (the forward kernel's allowance,
`tests/test_torch_kernel_cuda.py`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import halogen_tpu_torch as ht
from halogen_tpu_torch.diff import render_loss_grad
from halogen_tpu_torch.diff.grad import FLOAT_MATERIAL_FIELDS
from halogen_tpu_torch.integrator.camera import generate_rays
from halogen_tpu_torch.integrator.trace import _sampler_2d
from halogen_tpu_torch.kernels import adjoint as adj
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.sampler import sobol as sob
from halogen_tpu_torch.scene import cornell
from halogen_tpu_torch.scene.envmap import Envmap

CASES = {
    "sobol_rr": dict(max_bounces=4),
    "sobol_no_rr": dict(max_bounces=4, russian_roulette=False),
    "prng_rr": dict(max_bounces=4, sampler=ht.SamplerKind.PRNG),
    "bounce_limits": dict(max_bounces=6, max_diffuse_bounces=1,
                          max_glossy_bounces=2, russian_roulette=False),
}
GLASS_CASES = {
    "sobol_rr": dict(),
    "sobol_no_rr": dict(russian_roulette=False),
    "prng_rr": dict(sampler=ht.SamplerKind.PRNG),
    "transmission_limit": dict(max_transmission_bounces=2),
}
CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)


def _glass_settings(case):
    return ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                             max_bounces=8, **{"max_transmission_bounces": 8,
                                               **GLASS_CASES[case]})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def assert_columns_close(got, ref):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(got).all()
    bound = 1e-3 * np.abs(ref).max(axis=0) + 1e-6
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max(axis=0)


def _rays(dev, st, lanes=2):
    cam = ht.make_camera(**CAM, device=dev)
    pix = torch.arange(st.num_pixels, device=dev).repeat_interleave(lanes)
    lane = torch.arange(lanes, device=dev).repeat(st.num_pixels)
    sidx = sob.sample_index(1, lane, st.samples_per_pixel)
    seed = sob.pixel_seed(pix)
    o, d = generate_rays(cam, pix % st.width, pix // st.width, st.width,
                         st.height, st.filter_radius, sidx, seed,
                         _sampler_2d(st))
    g = torch.Generator().manual_seed(0)
    ct = torch.rand((o.shape[0], 3), generator=g).to(dev)
    return cam, o, d, sidx, seed, ct


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_adjoint_matches_plain_on_card(case, cuda_device):
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                           **CASES[case])
    scene = cornell.cornell_box(glossy=True).build(device=cuda_device)
    cam, o, d, sidx, seed, ct = _rays(cuda_device, st)
    before = adj.LAUNCHES
    got = adj.trace_grad_fused_materials(scene, o, d, cam.far, sidx, seed,
                                         ct, st)
    assert adj.LAUNCHES == before + 1
    ref = adj.trace_grad_fused_materials_reference(scene, o, d, cam.far,
                                                   sidx, seed, ct, st)
    torch.cuda.synchronize()
    assert got.shape == (scene.materials.count, adj.N_GRAD)
    assert_columns_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GLASS_CASES))
def test_glass_adjoint_matches_plain_on_card(case, cuda_device):
    """B2b: the medium stack in the replay, absorption routed to the
    current medium's material."""
    st = _glass_settings(case)
    scene = cornell.glass_sphere_box().build(device=cuda_device)
    assert adj.adjoint_supported(scene, st)
    cam, o, d, sidx, seed, ct = _rays(cuda_device, st)
    before = adj.LAUNCHES
    got = adj.trace_grad_fused_materials(scene, o, d, cam.far, sidx, seed,
                                         ct, st)
    assert adj.LAUNCHES == before + 1
    ref = adj.trace_grad_fused_materials_reference(scene, o, d, cam.far,
                                                   sidx, seed, ct, st)
    torch.cuda.synchronize()
    assert float(ref[:, 9:12].abs().max()) > 0  # absorption is exercised
    assert_columns_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("glass", [False, True])
def test_adjoint_is_bitwise_repeatable_and_replays_forward(glass,
                                                           cuda_device):
    """Two calls give the same bits, and the replay's color is the forward
    kernel's, bit for bit (both run path_common.cuh's bounce)."""
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                           max_bounces=6)
    scene = (cornell.glass_sphere_box() if glass
             else cornell.cornell_box(glossy=True)).build(device=cuda_device)
    cam, o, d, sidx, seed, ct = _rays(cuda_device, st)
    replay = torch.empty_like(o)
    a = adj._launch(scene, o, d, cam.far, sidx, seed, ct, st, None, replay)
    b = adj.trace_grad_fused_materials(scene, o, d, cam.far, sidx, seed, ct,
                                       st)
    fwd = mk.trace_color_fused(scene, o, d, cam.far, sidx, seed, st)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(replay, fwd)


@pytest.mark.cuda
def test_render_loss_grad_launches_both_kernels(cuda_device):
    """On a CUDA scene the image has a grad_fn, and render_loss_grad runs
    the megakernel forward and the adjoint backward, one launch of each
    per spp group; its grads agree with the plain route (Fused.OFF) at the
    tolerance above."""
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=4,
                           max_bounces=4, ray_chunk_size=2048)
    scene = cornell.cornell_box(glossy=True).build(device=cuda_device)
    cam = ht.make_camera(**CAM, device=cuda_device)
    target = torch.zeros((32, 32, 3), device=cuda_device)
    params = {"materials": scene.materials}
    mats = dataclasses.replace(
        scene.materials,
        albedo=scene.materials.albedo.clone().requires_grad_(True))
    img = ht.render_frame(dataclasses.replace(scene, materials=mats), cam,
                          st, 1)
    assert img.grad_fn is not None
    f0, b0 = mk.LAUNCHES, adj.LAUNCHES
    loss, grads = render_loss_grad(params, scene, cam, st, target, 1)
    assert (mk.LAUNCHES - f0, adj.LAUNCHES - b0) == (2, 2)
    loss_off, grads_off = render_loss_grad(
        params, scene, cam, st.replace(fused=ht.Fused.OFF), target, 1)
    assert (mk.LAUNCHES - f0, adj.LAUNCHES - b0) == (2, 2)
    assert torch.isfinite(loss) and abs(float(loss) - float(loss_off)) <= (
        1e-4 * float(loss_off))
    for f in FLOAT_MATERIAL_FIELDS:
        g = getattr(grads["materials"], f)
        assert torch.isfinite(g).all(), f
        ref = getattr(grads_off["materials"], f)
        assert_columns_close(g.reshape(g.shape[0], -1),
                             ref.reshape(ref.shape[0], -1))


@pytest.mark.cuda
def test_gradient_over_kernel_caps_raises_on_card(cuda_device):
    """A CUDA scene over the kernels' caps (36 spheres) is refused on the
    gradient route too."""
    st = ht.RenderSettings(width=8, height=8, samples_per_pixel=2,
                           max_bounces=2)
    scene = cornell.material_demo_spheres(rows=6, cols=6).build(
        device=cuda_device)
    cam = ht.make_camera(position=(0, 2, 6), target=(0, 0.5, -3),
                         fov_deg=50, device=cuda_device)
    before = (mk.LAUNCHES, adj.LAUNCHES)
    with pytest.raises(NotImplementedError, match="ROADMAP A8, A9"):
        render_loss_grad({"materials": scene.materials}, scene, cam, st,
                         torch.zeros((8, 8, 3), device=cuda_device), 1)
    assert (mk.LAUNCHES, adj.LAUNCHES) == before


@pytest.mark.cuda
def test_envmap_backward_raises_on_card(cuda_device):
    """An envmap scene renders through the kernel on the card, but its
    backward (the JAX package's lockstep-vjp route) is not ported: the
    backward raises, naming the ROADMAP item."""
    st = ht.RenderSettings(width=8, height=8, samples_per_pixel=2,
                           max_bounces=2, use_envmap=True)
    scene = cornell.cornell_box(glossy=True).build(
        envmap=Envmap.gradient_sky(), device=cuda_device)
    cam = ht.make_camera(**CAM, device=cuda_device)
    assert not adj.adjoint_supported(scene, st)
    before = adj.LAUNCHES
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        render_loss_grad({"materials": scene.materials}, scene, cam, st,
                         torch.zeros((8, 8, 3), device=cuda_device), 1)
    assert adj.LAUNCHES == before
