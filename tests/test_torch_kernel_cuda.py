"""The CUDA megakernel vs its plain PyTorch version on the card: the
opaque variant (B1a) on Cornell glossy, the medium-stack variant (B1b) on
the glass-in-glass box, the envmap variants (B1c) with the sky shaded
after the kernel, with and without env NEE, and the BVH tier (B1d) on the
glass dragon and on a dragon under the sky with env NEE; and the
world-BVH traversal kernel (B3) against its plain version, with every
`Intersector` route that reaches it.

Needs an NVIDIA GPU with nvcc; skips without one. Imports no JAX, so it
also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_kernel_cuda.py -q

Tolerance: the kernel is built with -fmad=false and follows the Pallas
body op for op, the plain version the lockstep integrator; the two differ
in the rounding of a few ops (v * (1/x) vs v / x, sin/cos/exp), which can
flip a rare Russian-roulette or edge decision. So atol = rtol = 1e-4 per
ray, with at most 0.1% of rays outside. Glass adds `expf` in
Beer-Lambert and env NEE `sinf`/`cosf` in the draw, which round as torch's
within an ulp; the same bound holds, except for env NEE's continuation
pdf at the miss (output 10), held at rtol 1e-2 (see below).
"""

import numpy as np
import pytest
import torch

import halogen_tpu_torch as ht
from halogen_tpu_torch.integrator.camera import generate_rays
from halogen_tpu_torch.integrator.trace import (
    _sampler_2d,
    deferred_sky,
    env_mis_weight,
)
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.kernels import traverse
from halogen_tpu_torch.sampler import sobol as sob
from halogen_tpu_torch.scene import cornell, meshes
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
SKY_CAM = dict(position=(0, 1, 6), target=(0, 0.5, 0), fov_deg=40)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _check_kernel_vs_plain(scene, cam_kw, st, dev, as_read=False):
    """Kernel vs plain on 2 lanes of every pixel: the per-ray outputs and
    the color after the sky pass, one launch each way.

    `as_read` (the BVH tier's scenes) holds the final direction (outputs
    7-9) and the continuation pdf (output 10) where and as the sky pass
    reads them: on rays that reached the sky (a nonzero miss
    attenuation), and the pdf through the balance-heuristic weight it
    gives the sky (`env_mis_weight`). A killed ray's last direction is
    never read; on the dragons it drifts over 12 bounces through curved
    glass from ulp-level differences. The pdf grows without bound toward
    the rim of a 0.05-roughness lobe's support and is 0 past it, so an
    ulp of direction moves it past rtol 1e-2 while its weight stays near
    1. The
    color after the sky pass is held on every ray."""
    cam = ht.make_camera(**cam_kw, device=dev)
    pix = torch.arange(st.num_pixels, device=dev).repeat_interleave(2)
    lane = torch.arange(2, device=dev).repeat(st.num_pixels)
    sidx = sob.sample_index(1, lane, st.samples_per_pixel)
    seed = sob.pixel_seed(pix)
    o, d = generate_rays(cam, pix % st.width, pix // st.width, st.width,
                         st.height, st.filter_radius, sidx, seed,
                         _sampler_2d(st))
    before = mk.LAUNCHES
    got = mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st)
    color = mk.trace_color_fused(scene, o, d, cam.far, sidx, seed, st)
    assert mk.LAUNCHES == before + 2
    ref = mk.trace_color_fused_reference(scene, o, d, cam.far, sidx, seed, st)
    ref_color = deferred_sky(scene, st, ref)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (pix.shape[0], ref.shape[1])
    # outputs 0-9 and 11, and the color after the sky pass, at 1e-4
    # (output 11 is a flag); output 10, the continuation pdf at the miss,
    # at rtol 1e-2: a near-mirror glossy lobe's pdf (up to ~1e3) turns the
    # ~1e-6 direction differences into ~1e-3 relative ones
    cols = [c for c in range(got.shape[1]) if c != 10]
    pairs = [(got[:, cols], ref[:, cols], 1e-4), (color, ref_color, 1e-4)]
    if as_read:
        read = (ref[:, 3:6] != 0).any(dim=1)
        keep = [c for c in cols if c not in (7, 8, 9)]
        pairs[0] = (got[:, keep], ref[:, keep], 1e-4)
        pairs.append((got[read, 7:10], ref[read, 7:10], 1e-4))
        if got.shape[1] > 10:
            pairs.append(tuple(env_mis_weight(scene, x)[read, None]
                               for x in (got, ref)) + (1e-2,))
    elif got.shape[1] > 10:
        pairs.append((got[:, 10:11], ref[:, 10:11], 1e-2))
    for a, b, rtol in pairs:
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert np.isfinite(a).all()
        bad = (np.abs(a - b) > 1e-4 + rtol * np.abs(b)).any(axis=1)
        assert bad.sum() <= max(1, a.shape[0] // 1000), (
            f"{bad.sum()} of {a.shape[0]} rays outside, max |diff| "
            f"{np.abs(a - b).max()}")
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case, cuda_device):
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                           **CASES[case])
    scene = cornell.cornell_box(glossy=True).build(device=cuda_device)
    got = _check_kernel_vs_plain(scene, CAM, st, cuda_device)
    assert got.shape[1] == mk.N_OUTPUTS


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GLASS_CASES))
def test_glass_kernel_matches_plain_on_card(case, cuda_device):
    """B1b: the glass-in-glass box at 8 bounces."""
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                           max_bounces=8, **{"max_transmission_bounces": 8,
                                             **GLASS_CASES[case]})
    scene = cornell.glass_sphere_box().build(device=cuda_device)
    assert scene.any_transmissive and mk.fused_supported(scene, st)
    _check_kernel_vs_plain(scene, CAM, st, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("nee", [False, True])
def test_envmap_kernel_matches_plain_on_card(nee, cuda_device):
    """B1c: Cornell glossy under the sky with the mip bias (the kernel
    records the miss, the sky is shaded after it), and the material demo
    spheres with env NEE at mip level 0 (12 outputs)."""
    sky = Envmap.gradient_sky()
    if nee:
        scene = cornell.material_demo_spheres().build(envmap=sky,
                                                      device=cuda_device)
        st = ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                               max_bounces=4, use_envmap=True,
                               env_importance_sampling=True, env_mip_level=0)
        cam = SKY_CAM
    else:
        scene = cornell.cornell_box(glossy=True).build(envmap=sky,
                                                       device=cuda_device)
        st = ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                               max_bounces=3, use_envmap=True)
        cam = CAM
    got = _check_kernel_vs_plain(scene, cam, st, cuda_device)
    assert got.shape[1] == (mk.N_OUTPUTS_NEE if nee else mk.N_OUTPUTS)
    if nee:
        assert bool((got[:, 11] > 0.5).any())  # NEE-covered misses occur


@pytest.mark.cuda
def test_glass_env_nee_kernel_matches_plain_on_card(cuda_device):
    """B1b and B1c together: the glass-in-glass box under the sky with env
    NEE."""
    scene = cornell.glass_sphere_box().build(envmap=Envmap.gradient_sky(),
                                             device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                           max_bounces=8, max_transmission_bounces=8,
                           use_envmap=True, env_importance_sampling=True,
                           env_mip_level=0)
    got = _check_kernel_vs_plain(scene, CAM, st, cuda_device)
    assert got.shape[1] == mk.N_OUTPUTS_NEE


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "glass", "sky_nee"])
def test_render_frame_launches_kernel(name, cuda_device):
    """render_frame on a CUDA scene goes through the kernel: one launch
    per spp group, and the frame agrees with the plain version's (at most
    one pixel outside 1e-4, for the reason above)."""
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=4,
                           max_bounces=4, ray_chunk_size=2048)
    cam_kw = CAM
    if name == "cornell":
        scene = cornell.cornell_box(glossy=True).build(device=cuda_device)
    elif name == "glass":
        scene = cornell.glass_sphere_box().build(device=cuda_device)
    else:
        scene = cornell.material_demo_spheres().build(
            envmap=Envmap.gradient_sky(), device=cuda_device)
        st = st.replace(use_envmap=True, env_importance_sampling=True,
                        env_mip_level=0)
        cam_kw = SKY_CAM
    cam = ht.make_camera(**cam_kw, device=cuda_device)
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


DRAGON_CAM = dict(position=(0, 1.5, 5), target=(0, -0.3, 0), fov_deg=45)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GLASS_CASES))
def test_bvh_kernel_matches_plain_on_card(case, cuda_device):
    """B1d: the glass dragon (8,724 triangles, an air bubble in the glass)
    at 12 bounces, against the lockstep with brute-force hits."""
    st = ht.RenderSettings(width=64, height=64, samples_per_pixel=2,
                           max_bounces=12, **GLASS_CASES[case])
    scene = meshes.glass_dragon_scene().build(device=cuda_device)
    assert mk.uses_bvh(scene) and mk.fused_supported(scene, st)
    _check_kernel_vs_plain(scene, DRAGON_CAM, st, cuda_device, as_read=True)


@pytest.mark.cuda
@pytest.mark.parametrize("nee", [False, True])
def test_bvh_sky_kernel_matches_plain_on_card(nee, cuda_device):
    """B1d under the sky: a 1,280-triangle dragon and its floor, with and
    without env NEE (the shadow ray is the any-hit walk)."""
    scene = meshes.dragons_hero_scene(1, tris=1280).build(
        envmap=Envmap.gradient_sky(), device=cuda_device)
    st = ht.RenderSettings(width=64, height=64, samples_per_pixel=2,
                           max_bounces=4, use_envmap=True,
                           env_importance_sampling=nee, env_mip_level=0)
    assert mk.uses_bvh(scene)
    _check_kernel_vs_plain(scene, DRAGON_CAM, st, cuda_device, as_read=True)


def _traverse_rays(scene, n, dev, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s = rng.choice(np.asarray([np.inf, 1e30, -1.0], np.float32), n)
    k = n // 4
    s[:k] = rng.uniform(0.2, 3.0, k)  # sphere-like finite seeds
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(o), t(d), t(s)


@pytest.mark.cuda
def test_traverse_matches_plain_on_card(cuda_device):
    """B3 vs its plain version on 16,384 rays inside the glass dragon's
    box: t, u and v at 1e-5, the triangle equal except at ties."""
    scene = meshes.glass_dragon_scene().build(device=cuda_device)
    o, d, seed = _traverse_rays(scene, 16384, cuda_device)
    before = traverse.LAUNCHES
    got = traverse.traverse_world(scene.wbvh, o, d, seed)
    assert traverse.LAUNCHES == before + 1
    ref = traverse.traverse_world_reference(scene.wbvh, o, d, seed)
    got = [x.cpu().numpy() for x in got]
    ref = [x.cpu().numpy() for x in ref]
    np.testing.assert_array_equal(np.isinf(got[0]), np.isinf(ref[0]))
    hit = np.isfinite(ref[0])
    assert hit.mean() > 0.2
    for i in (0, 2, 3):
        np.testing.assert_allclose(got[i][hit], ref[i][hit], atol=1e-5,
                                   rtol=1e-5)
    other = got[1] != ref[1]
    assert other.sum() <= 16  # ties at shared edges: 0.1%
    assert (got[1][~hit] == -1).all() and (got[5] > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["PALLAS", "TREELET", "FLATLET", "RAYLET"])
def test_world_routes_launch_the_traversal_kernel(kind, cuda_device):
    """Each world-BVH `Intersector` reaches B3 on the card and its lockstep
    frame agrees with BRUTE's."""
    scene = meshes.glass_dragon_scene().build(device=cuda_device)
    cam = ht.make_camera(**DRAGON_CAM, device=cuda_device)
    st = ht.RenderSettings(width=16, height=16, samples_per_pixel=2,
                           max_bounces=4, fused=ht.Fused.OFF,
                           ray_chunk_size=1024)
    traverse.LAUNCHES = 0
    img = ht.render_frame(scene, cam, st.replace(
        intersector=ht.Intersector[kind]), 1).cpu().numpy()
    assert traverse.LAUNCHES > 0
    traverse.LAUNCHES = 0
    ref = ht.render_frame(scene, cam, st.replace(
        intersector=ht.Intersector.BRUTE), 1).cpu().numpy()
    assert traverse.LAUNCHES == 0
    bad = (np.abs(img - ref) > 1e-4 + 1e-4 * np.abs(ref)).any(axis=-1)
    assert bad.sum() <= 1


@pytest.mark.cuda
def test_big_scene_frame_launches_bvh_tier(cuda_device):
    """render_frame on the glass dragon goes through B1d (one launch per
    group); under Fused.OFF the lockstep's AUTO takes B3; the backward of
    the kernel route raises, naming A9."""
    from halogen_tpu_torch.diff import render_loss_grad

    scene = meshes.glass_dragon_scene().build(device=cuda_device)
    cam = ht.make_camera(**DRAGON_CAM, device=cuda_device)
    st = ht.RenderSettings(width=16, height=16, samples_per_pixel=2,
                           max_bounces=6, ray_chunk_size=1024)
    before = (mk.LAUNCHES, traverse.LAUNCHES)
    img = ht.render_frame(scene, cam, st, 1)
    assert (mk.LAUNCHES - before[0], traverse.LAUNCHES - before[1]) == (1, 0)
    off = ht.render_frame(scene, cam, st.replace(fused=ht.Fused.OFF), 1)
    assert traverse.LAUNCHES > before[1] and mk.LAUNCHES - before[0] == 1
    assert bool(torch.isfinite(img).all())
    rel = abs(float(img.mean()) - float(off.mean())) / float(off.mean())
    assert rel < 2e-2
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        render_loss_grad({"materials": scene.materials}, scene, cam, st,
                         torch.zeros((16, 16, 3), device=cuda_device), 1)
