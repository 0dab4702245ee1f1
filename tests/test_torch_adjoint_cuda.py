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
from halogen_tpu_torch.integrator.trace import _sampler_2d, deferred_sky
from halogen_tpu_torch.kernels import adjoint as adj
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.kernels import sky
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
    assert adj.adjoint_covers(scene, st)
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
@pytest.mark.parametrize("glass", [False, True])
def test_transcript_routes_give_the_same_bits(glass, cuda_device):
    """The transcript in shared memory (the route at 6 bounces) and in
    device memory give the same [K, 12] bits: the same arithmetic, the
    same order of sums."""
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                           max_bounces=6)
    scene = (cornell.glass_sphere_box() if glass
             else cornell.cornell_box(glossy=True)).build(device=cuda_device)
    assert adj.transcript_route(scene, st) == "shared"
    cam, o, d, sidx, seed, ct = _rays(cuda_device, st)
    shared = adj._launch(scene, o, d, cam.far, sidx, seed, ct, st, None,
                         route="shared")
    dev_mem = adj._launch(scene, o, d, cam.far, sidx, seed, ct, st, None,
                          route="global")
    torch.cuda.synchronize()
    assert torch.equal(shared, dev_mem)


@pytest.mark.cuda
def test_global_route_above_the_shared_cap(cuda_device):
    """B2b at a bounce count whose transcript exceeds the shared-memory
    budget takes the global route: it matches the plain version, is
    bitwise repeatable and replays the forward bit for bit."""
    st = _glass_settings("sobol_no_rr").replace(max_bounces=20,
                                                max_transmission_bounces=20)
    scene = cornell.glass_sphere_box().build(device=cuda_device)
    assert adj.transcript_route(scene, st) == "global"
    cam, o, d, sidx, seed, ct = _rays(cuda_device, st)
    replay = torch.empty_like(o)
    got = adj._launch(scene, o, d, cam.far, sidx, seed, ct, st, None, replay)
    again = adj.trace_grad_fused_materials(scene, o, d, cam.far, sidx, seed,
                                           ct, st)
    fwd = mk.trace_color_fused(scene, o, d, cam.far, sidx, seed, st)
    ref = adj.trace_grad_fused_materials_reference(scene, o, d, cam.far,
                                                   sidx, seed, ct, st)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(replay, fwd)
    assert_columns_close(got, ref)


@pytest.mark.cuda
def test_render_loss_grad_launches_both_kernels(cuda_device):
    """On a CUDA scene the image has a grad_fn, and render_loss_grad runs
    the megakernel forward and the adjoint backward, one launch of each
    per spp group: on the record route (the brute tier records too) a
    recording forward and a sweep, no replay; with RECORD_BUDGET = 0 a
    forward and a replay, with the same gradients bit for bit. Its grads
    agree with the plain route (Fused.OFF) at the tolerance above."""
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
    counts = lambda: (mk.LAUNCHES, mk.RECORD_LAUNCHES, adj.LAUNCHES,
                      adj.SWEEP_LAUNCHES)
    assert not mk.uses_bvh(scene)
    assert adj.record_plan(scene, st, 2048, 2) == "recorded"
    before = counts()
    loss, grads = render_loss_grad(params, scene, cam, st, target, 1)
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 2, 0, 2)
    saved = adj.RECORD_BUDGET
    adj.RECORD_BUDGET = 0
    try:
        before = counts()
        loss_rep, grads_rep = render_loss_grad(params, scene, cam, st,
                                               target, 1)
        assert tuple(a - b for a, b in zip(counts(), before)) == (
            2, 0, 2, 0)
    finally:
        adj.RECORD_BUDGET = saved
    assert torch.equal(loss, loss_rep)
    for f in FLOAT_MATERIAL_FIELDS:
        assert torch.equal(getattr(grads["materials"], f),
                           getattr(grads_rep["materials"], f)), f
    before = counts()
    loss_off, grads_off = render_loss_grad(
        params, scene, cam, st.replace(fused=ht.Fused.OFF), target, 1)
    assert counts() == before
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
    with pytest.raises(NotImplementedError, match="fused tiers' caps"):
        render_loss_grad({"materials": scene.materials}, scene, cam, st,
                         torch.zeros((8, 8, 3), device=cuda_device), 1)
    assert (mk.LAUNCHES, adj.LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("nee", [False, True], ids=["sky", "env_nee"])
def test_envmap_backward_runs_on_card(cuda_device, nee):
    """An envmap scene's backward runs on the card, with and without env
    NEE: render_loss_grad with {"materials", "env_mips"} launches the
    megakernel (recording), the sky forward, the sky backward and the
    adjoint's sweep once a group, no replay, and its grads agree with the
    plain route (Fused.OFF): materials per column, every mip at 1e-4 of
    its largest + 1e-6 (with env NEE the finest mip also sums the
    adjoint's records)."""
    st = ht.RenderSettings(width=16, height=16, samples_per_pixel=2,
                           max_bounces=3, use_envmap=True,
                           env_importance_sampling=nee, env_mip_level=0,
                           ray_chunk_size=256)
    scene = cornell.cornell_box(glossy=True).build(
        envmap=Envmap.gradient_sky(), device=cuda_device)
    cam = ht.make_camera(**CAM, device=cuda_device)
    assert adj.adjoint_covers(scene, st)
    params = {"materials": scene.materials, "env_mips": scene.env_mips}
    target = torch.zeros((16, 16, 3), device=cuda_device)
    counts = lambda: (mk.LAUNCHES, mk.RECORD_LAUNCHES, adj.SWEEP_LAUNCHES,
                      sky.FORWARD_LAUNCHES, sky.BACKWARD_LAUNCHES,
                      adj.LAUNCHES)
    before = counts()
    loss, grads = render_loss_grad(params, scene, cam, st, target, 1)
    assert tuple(a - b for a, b in zip(counts(), before)) == (
        2, 2, 2, 2, 2, 0)
    _, ref = render_loss_grad(params, scene, cam,
                              st.replace(fused=ht.Fused.OFF), target, 1)
    assert torch.isfinite(loss)
    for f in FLOAT_MATERIAL_FIELDS:
        g, r = getattr(grads["materials"], f), getattr(ref["materials"], f)
        assert_columns_close(g.reshape(g.shape[0], -1),
                             r.reshape(r.shape[0], -1))
    for g, r in zip(grads["env_mips"], ref["env_mips"]):
        assert torch.isfinite(g).all()
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max()) + 1e-6


ENV_CASES = {
    "sky": dict(use_envmap=True),
    "sky_nee": dict(use_envmap=True, env_importance_sampling=True,
                    env_mip_level=0),
}


def _scene(name, env, dev):
    from halogen_tpu_torch.scene import meshes

    sky_map = Envmap.gradient_sky() if env else None
    if name == "cornell":
        return cornell.cornell_box(glossy=True).build(envmap=sky_map,
                                                      device=dev), CAM
    if name == "cornell_box":  # the diffuse box: a triangle light
        return cornell.cornell_box().build(envmap=sky_map, device=dev), CAM
    if name == "glow_orbs":  # sphere lights
        return cornell.glow_orbs().build(envmap=sky_map, device=dev), CAM
    if name == "glass":
        return cornell.glass_sphere_box().build(envmap=sky_map,
                                                device=dev), CAM
    if name == "spheres":  # the envmap_1024 preset's scene
        return cornell.material_demo_spheres().build(
            envmap=sky_map, device=dev), dict(position=(0, 1, 6),
                                              target=(0, 0.5, 0), fov_deg=40)
    dcam = dict(position=(0, 1.5, 5.0), target=(0, -0.3, 0), fov_deg=45)
    if name == "glass_dragon":
        return meshes.glass_dragon_scene().build(envmap=sky_map,
                                                 device=dev), dcam
    if name == "metal_dragon":  # 1,280 metal triangles in the Cornell shell
        from halogen_tpu_torch.scene.material import Material

        box = cornell.cornell_box(with_spheres=False)
        verts, faces = meshes.dragon_mesh(3)
        box.add_mesh(verts, faces, Material.metal((0.9, 0.6, 0.5),
                                                  roughness=0.4),
                     transform=meshes._scale_translate(0.55,
                                                       (0.0, -0.45, 0.0)))
        return box.build(envmap=sky_map, device=dev), dcam
    return meshes.dragons_hero_scene(1, tris=1280).build(envmap=sky_map,
                                                         device=dev), dcam


def _scene_rays(dev, st, cam_kw, lanes=2):
    cam = ht.make_camera(**cam_kw, device=dev)
    pix = torch.arange(st.num_pixels, device=dev).repeat_interleave(lanes)
    lane = torch.arange(lanes, device=dev).repeat(st.num_pixels)
    sidx = sob.sample_index(1, lane, st.samples_per_pixel)
    seed = sob.pixel_seed(pix)
    o, d = generate_rays(cam, pix % st.width, pix // st.width, st.width,
                         st.height, st.filter_radius, sidx, seed,
                         _sampler_2d(st))
    ct = torch.rand((o.shape[0], 3),
                    generator=torch.Generator().manual_seed(0)).to(dev)
    return cam, o, d, sidx, seed, ct


def _check_variant(scene, st, cam, o, d, sidx, seed, ct):
    """Kernel vs plain ([K, 12|13] per column, every mip at 1e-4 of its
    largest + 1e-6) on the rays whose forward outputs the two agree on
    (color after the sky, miss attenuation, roughness at 1e-4; at most
    0.1% may not: a near-mirror lobe's pdf), two calls bitwise equal, and
    the replay's color equal to the forward kernel's bit for bit."""
    out_k = mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st)
    out_p = mk.trace_color_fused_reference(scene, o, d, cam.far, sidx, seed,
                                           st)
    pair = [torch.cat([deferred_sky(scene, st, x), x[:, 3:7]], dim=1)
            for x in (out_k, out_p)]
    agree = ((pair[0] - pair[1]).abs()
             <= 1e-4 + 1e-4 * pair[1].abs()).all(dim=1)
    assert int((~agree).sum()) <= max(1.0, 1e-3 * o.shape[0])
    ct = ct * agree[:, None]
    got, env = adj.trace_grad_fused(scene, o, d, cam.far, sidx, seed, ct, st)
    again, env2 = adj.trace_grad_fused(scene, o, d, cam.far, sidx, seed, ct,
                                       st)
    ref, ref_env = adj.trace_grad_fused_reference(scene, o, d, cam.far,
                                                  sidx, seed, ct, st)
    replay = torch.empty_like(o)
    gsky = (torch.zeros((o.shape[0], 4), device=o.device)
            if adj.env_mode(scene, st) else None)
    adj._launch(scene, o, d, cam.far, sidx, seed, ct, st, None, replay,
                gsky=gsky)
    fwd = mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st)
    torch.cuda.synchronize()
    assert got.shape == (scene.materials.count, adj.n_grad(scene, st))
    assert_columns_close(got, ref)
    assert torch.equal(got, again)
    assert torch.equal(replay, fwd[:, 0:3])
    assert (env is None) == (ref_env is None)
    for g, g2, r in zip(env or (), env2 or (), ref_env or ()):
        assert torch.equal(g, g2)
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["glass_dragon", "metal_dragon"])
def test_bvh_adjoint_matches_plain_on_card(name, cuda_device):
    """B2b+d on the glass dragon (8,724 triangles, 12 bounces) and B2+d on
    a 1,280-triangle metal dragon in the Cornell shell: vs the plain
    version (brute-force hits), bitwise repeatable, the replay equal to
    B1d's forward."""
    scene, cam_kw = _scene(name, False, cuda_device)
    assert mk.uses_bvh(scene)
    st = ht.RenderSettings(width=16, height=16, samples_per_pixel=2,
                           max_bounces=12 if name == "glass_dragon" else 4)
    _check_variant(scene, st, *_scene_rays(cuda_device, st, cam_kw))


@pytest.mark.cuda
@pytest.mark.parametrize("env", sorted(ENV_CASES))
@pytest.mark.parametrize("name", ["cornell", "glass", "hero"])
def test_env_adjoint_matches_plain_on_card(name, env, cuda_device):
    """The adjoint's sky variants (B2c, B2c+n; with the stack; on the BVH
    tier) through the sky backward kernel, vs the plain version."""
    scene, cam_kw = _scene(name, True, cuda_device)
    st = ht.RenderSettings(width=16, height=16, samples_per_pixel=2,
                           max_bounces=8 if name == "glass" else 4,
                           max_transmission_bounces=8, **ENV_CASES[env])
    _check_variant(scene, st, *_scene_rays(cuda_device, st, cam_kw))


@pytest.mark.cuda
def test_env_nee_transcript_routes_give_the_same_bits(cuda_device):
    """With env NEE the transcript is 40 bytes a bounce: at 12 bounces
    the glass box under the sky passes the shared-memory budget; both
    routes give the same bits where both fit (4 bounces)."""
    scene, cam_kw = _scene("glass", True, cuda_device)
    st = ht.RenderSettings(width=16, height=16, samples_per_pixel=2,
                           max_bounces=4, **ENV_CASES["sky_nee"])
    cam, o, d, sidx, seed, ct = _scene_rays(cuda_device, st, cam_kw)
    gsky = torch.rand((o.shape[0], 4),
                      generator=torch.Generator().manual_seed(1)).to(
                          cuda_device)
    out = [adj._launch(scene, o, d, cam.far, sidx, seed, ct, st, None,
                       route=r, gsky=gsky) for r in ("shared", "global")]
    torch.cuda.synchronize()
    assert torch.equal(out[0], out[1])
    assert adj.transcript_route(scene, st.replace(max_bounces=12)) == "global"


# the record route's variants on both tiers: (scene, sky, settings); the
# brute tier's forward variants B1a (B2), B1b (B2b), B1c (B2c+n) and B1b+c
# (B2b+c+n) record as the BVH tier's do
RECORD_CASES = {
    "B2": ("cornell", False, dict(max_bounces=6)),
    "B2b": ("glass", False, dict(max_bounces=8, max_transmission_bounces=8)),
    "B2c": ("cornell", True, dict(max_bounces=4, **ENV_CASES["sky"])),
    "B2c+n": ("spheres", True, dict(max_bounces=4, **ENV_CASES["sky_nee"])),
    "B2b+c+n": ("glass", True, dict(max_bounces=8,
                                    max_transmission_bounces=8,
                                    **ENV_CASES["sky_nee"])),
    "B2+d": ("metal_dragon", False, dict(max_bounces=12)),
    "B2b+d": ("glass_dragon", False, dict(max_bounces=12)),
    "B2c+d": ("hero", True, dict(max_bounces=4, **ENV_CASES["sky"])),
    "B2c+n+d": ("hero", True, dict(max_bounces=4, **ENV_CASES["sky_nee"])),
    "B2b+c+n+d": ("glass_dragon", True,
                  dict(max_bounces=12, **ENV_CASES["sky_nee"])),
}


# area-light NEE (B2+l): the record route alone, on both tiers
LIGHT = dict(light_importance_sampling=True)
LIGHT_CASES = {
    "B2+l": ("cornell_box", False, dict(max_bounces=6, **LIGHT)),
    "B2+l_orbs": ("glow_orbs", False, dict(max_bounces=6, **LIGHT)),
    "B2b+l": ("glass", False, dict(max_bounces=8,
                                   max_transmission_bounces=8, **LIGHT)),
    "B2c+n+l": ("cornell", True, dict(max_bounces=4, **ENV_CASES["sky_nee"],
                                      **LIGHT)),
    "B2+l+d": ("metal_dragon", False, dict(max_bounces=12, **LIGHT)),
    "B2b+l+d": ("glass_dragon", False, dict(max_bounces=12, **LIGHT)),
}


def _recorded(name, dev):
    """(scene, settings, camera, rays, ct, gsky, the forward's outputs
    with and without the record, the record) for a record-route case."""
    kind, env, kw = {**RECORD_CASES, **LIGHT_CASES}[name]
    scene, cam_kw = _scene(kind, env, dev)
    assert mk.uses_bvh(scene) == name.endswith("+d")
    st = ht.RenderSettings(width=16, height=16, samples_per_pixel=2, **kw)
    cam, o, d, sidx, seed, ct = _scene_rays(dev, st, cam_kw)
    gsky = torch.rand((o.shape[0], 4),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    nee = adj.env_mode(scene, st) == 2
    rec = mk.empty_record(o.shape[0], st, nee, dev,
                          st.light_importance_sampling)
    before = mk.RECORD_LAUNCHES
    out_rec = mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st,
                                     record=rec)
    assert mk.RECORD_LAUNCHES == before + 1
    out = mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st)
    return scene, st, cam, (o, d, sidx, seed), ct, gsky, out_rec, out, rec


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RECORD_CASES))
def test_recorded_route_equals_the_replay_bit_for_bit(name, cuda_device):
    """The forward's outputs with the record equal those without; the
    sweep over the record gives the replay's [K, 12|13] and env-NEE
    records bit for bit, and is bitwise repeatable."""
    scene, st, cam, (o, d, sidx, seed), ct, gsky, out_rec, out, rec = (
        _recorded(name, cuda_device))
    env = adj.env_mode(scene, st)
    slots = st.max_bounces + 1
    n = o.shape[0]

    def nee_buffers():
        return (torch.full((n, slots), -7, dtype=torch.int32,
                           device=cuda_device),
                torch.zeros((n, slots, 3), device=cuda_device))

    got_recs, ref_recs = nee_buffers(), nee_buffers()
    kw = dict(gsky=gsky if env else None)
    before = adj.SWEEP_LAUNCHES
    got = adj._launch(scene, None, None, None, None, None, ct, st, None,
                      record=rec, records=got_recs if env == 2 else None,
                      **kw)
    again = adj._launch(scene, None, None, None, None, None, ct, st, None,
                        record=rec, **kw)
    assert adj.SWEEP_LAUNCHES == before + 2
    ref = adj._launch(scene, o, d, cam.far, sidx, seed, ct, st, None,
                      records=ref_recs if env == 2 else None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_rec, out)
    assert torch.equal(got, ref) and torch.equal(got, again)
    if env == 2:
        keys = got_recs[0]
        assert torch.equal(keys, ref_recs[0]) and int((keys >= 0).sum()) > 0
        lit = keys >= 0
        assert torch.equal(got_recs[1][lit], ref_recs[1][lit])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RECORD_CASES) + sorted(LIGHT_CASES))
def test_sweep_and_record_match_their_plain_versions(name, cuda_device):
    """The kernel's record against `record_transcript_reference` on the
    rays whose forward outputs kernel and plain agree on (ids and masks
    equal, floats within 1e-4; with light NEE its light words too), and
    the sweep against `sweep_reference` over the same record within 1e-5
    * max |column| + 1e-7."""
    scene, st, cam, (o, d, sidx, seed), ct, gsky, out_rec, _, rec = (
        _recorded(name, cuda_device))
    env = adj.env_mode(scene, st)
    plain = mk.trace_color_fused_reference(scene, o, d, cam.far, sidx, seed,
                                           st)
    agree = ((out_rec[:, 0:7] - plain[:, 0:7]).abs()
             <= 1e-4 + 1e-4 * plain[:, 0:7].abs()).all(dim=1)
    assert int((~agree).sum()) <= max(1.0, 1e-3 * o.shape[0])
    ref_rec = adj.record_transcript_reference(scene, o, d, cam.far, sidx,
                                              seed, st)
    assert torch.equal(rec.end[agree], ref_rec.end[agree])
    n_shaded = (rec.end.to(torch.int64) & 0xFFFF)
    for k in range(st.max_bounces + 1):
        live = agree & (n_shaded > k)
        assert torch.equal(rec.word[k][live], ref_rec.word[k][live]), k
        for a, b in ((rec.a, ref_rec.a), (rec.nq, ref_rec.nq),
                     (rec.ngw, ref_rec.ngw), (rec.lq, ref_rec.lq)):
            if a is not None and bool(live.any()):
                a, b = a[k][live], b[k][live]
                assert float((a - b).abs().max()) <= 1e-4 * (
                    1.0 + float(b.abs().max())), k
        if rec.texel is not None:
            assert torch.equal(rec.texel[k][live], ref_rec.texel[k][live])
    d_out = torch.cat([ct, gsky], dim=1)
    got = adj._launch(scene, None, None, None, None, None, ct, st, None,
                      record=rec, gsky=gsky if env else None)
    ref, _ = adj.sweep_reference(scene, st, rec, d_out)
    torch.cuda.synchronize()
    bound = 1e-5 * ref.abs().amax(dim=0) + 1e-7
    assert ((got - ref).abs() <= bound).all(), (got - ref).abs().amax(dim=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LIGHT_CASES))
def test_light_nee_forward_records_and_sweep_repeats(name, cuda_device):
    """With area-light NEE the recording forward (B1e's recording
    variants) gives the outputs of B1e without the record bit for bit and
    adds light terms to the record; the sweep (B2+l) is bitwise repeatable,
    and a caller that brings rays without a record gets the recording
    forward on them, then the sweep: the same bits, no replay."""
    scene, st, cam, (o, d, sidx, seed), ct, gsky, out_rec, out, rec = (
        _recorded(name, cuda_device))
    env = adj.env_mode(scene, st)
    kw = dict(gsky=gsky if env else None)
    counts = lambda: (mk.RECORD_LAUNCHES, adj.LAUNCHES, adj.SWEEP_LAUNCHES)
    got = adj._launch(scene, None, None, None, None, None, ct, st, None,
                      record=rec, **kw)
    again = adj._launch(scene, None, None, None, None, None, ct, st, None,
                        record=rec, **kw)
    before = counts()
    color = torch.empty_like(o)
    fresh = adj._launch(scene, o, d, cam.far, sidx, seed, ct, st, None,
                        color, **kw)
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 0, 1)
    torch.cuda.synchronize()
    assert torch.equal(out_rec, out)
    assert torch.equal(color, out[:, 0:3])
    assert torch.equal(got, again) and torch.equal(got, fresh)
    n_shaded = rec.end.to(torch.int64) & 0xFFFF
    slot = torch.arange(rec.word.shape[0], device=cuda_device)[:, None]
    lit = (slot < n_shaded[None]) & (
        (rec.word.to(torch.int64) & (1 << 27)) != 0)
    assert int(lit.sum()) > 0
    assert float(got[:, 0:3].abs().max()) > 0


@pytest.mark.cuda
def test_render_loss_grad_takes_the_record_route(cuda_device):
    """A BVH-tier step records in its forward and sweeps in its backward
    (no replay launch); with RECORD_BUDGET = 0 the same step replays; both
    give the same material gradients bit for bit."""
    scene, cam_kw = _scene("glass_dragon", False, cuda_device)
    cam = ht.make_camera(**cam_kw, device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=4,
                           max_bounces=12, ray_chunk_size=2048)
    target = torch.zeros((32, 32, 3), device=cuda_device)
    params = {"materials": scene.materials}
    counts = lambda: (mk.LAUNCHES, mk.RECORD_LAUNCHES, adj.LAUNCHES,
                      adj.SWEEP_LAUNCHES)
    assert adj.record_plan(scene, st, 2048, 2) == "recorded"
    before = counts()
    _, g_rec = render_loss_grad(params, scene, cam, st, target, 1)
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 2, 0, 2)
    saved = adj.RECORD_BUDGET
    adj.RECORD_BUDGET = 0
    try:
        before = counts()
        _, g_rep = render_loss_grad(params, scene, cam, st, target, 1)
        assert tuple(a - b for a, b in zip(counts(), before)) == (2, 0, 2, 0)
    finally:
        adj.RECORD_BUDGET = saved
    for f in FLOAT_MATERIAL_FIELDS:
        assert torch.equal(getattr(g_rec["materials"], f),
                           getattr(g_rep["materials"], f)), f
    assert float(g_rec["materials"].albedo.abs().sum()) > 0


@pytest.mark.cuda
def test_two_frames_before_one_backward_share_the_budget(cuda_device):
    """A loss over two frames keeps the first frame's records alive while
    the second is planned: with a budget of one frame's records the first
    frame records, the second replays, and the gradients equal those of
    two replayed frames bit for bit; the backward frees the records."""
    scene, cam_kw = _scene("glass_dragon", False, cuda_device)
    cam = ht.make_camera(**cam_kw, device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=4,
                           max_bounces=12, ray_chunk_size=2048)
    counts = lambda: (mk.RECORD_LAUNCHES, adj.LAUNCHES, adj.SWEEP_LAUNCHES)

    def grad_of_two_frames():
        leaf = scene.materials.albedo.detach().requires_grad_(True)
        sc = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, albedo=leaf))
        loss = (ht.render_frame(sc, cam, st, 1).square().sum()
                + ht.render_frame(sc, cam, st, 2).sum())
        return torch.autograd.grad(loss, leaf)[0]

    live0 = mk.live_record_bytes(cuda_device)
    saved = adj.RECORD_BUDGET
    try:
        adj.RECORD_BUDGET = live0 + 2 * adj.record_bytes(scene, st, 2048)
        before = counts()
        g_mixed = grad_of_two_frames()
        assert tuple(a - b for a, b in zip(counts(), before)) == (2, 2, 2)
        assert mk.live_record_bytes(cuda_device) == live0
        adj.RECORD_BUDGET = 0
        before = counts()
        g_replay = grad_of_two_frames()
        assert tuple(a - b for a, b in zip(counts(), before)) == (0, 4, 0)
    finally:
        adj.RECORD_BUDGET = saved
    assert torch.equal(g_mixed, g_replay)
    assert float(g_mixed.abs().sum()) > 0


# name: (scene, sky, settings beyond 32x32, 4 spp, two launches of 2048
# rays): the light-NEE variants the record and rerecord routes share
LIGHT_ROUTE_CASES = {
    "B1e": ("cornell", False, dict(max_bounces=4)),
    "B1c+e": ("cornell", True, dict(max_bounces=4, use_envmap=True,
                                    env_importance_sampling=True,
                                    env_mip_level=0)),
    "B1e+d": ("metal_dragon", False, dict(max_bounces=6)),
    "B1b+e+d": ("glass_dragon", False, dict(max_bounces=12)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LIGHT_ROUTE_CASES))
def test_light_nee_rerecord_route_equals_the_record_route(cuda_device,
                                                          case):
    """A light-NEE step past the budget (one launch's record fits, the
    step's two do not) records each group again in its backward: its
    forward launches the plain B1e variant a group and records nothing,
    its backward one recording launch and one sweep a group, and its loss
    and gradients (materials, with the sky every mip) equal the record
    route's bit for bit; the backward drops every record."""
    name, env, kw = LIGHT_ROUTE_CASES[case]
    scene, cam_kw = _scene(name, env, cuda_device)
    cam = ht.make_camera(**cam_kw, device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=4,
                           ray_chunk_size=2048,
                           light_importance_sampling=True, **kw)
    assert scene.lights is not None
    target = torch.zeros((32, 32, 3), device=cuda_device)
    params = {"materials": scene.materials}
    if env:
        params["env_mips"] = scene.env_mips
    counts = lambda: (mk.LAUNCHES, mk.RECORD_LAUNCHES, adj.LAUNCHES,
                      adj.SWEEP_LAUNCHES)
    live0 = mk.live_record_bytes(cuda_device)
    one = adj.record_bytes(scene, st, 2048)
    saved = adj.RECORD_BUDGET
    try:
        adj.RECORD_BUDGET = live0 + 2 * one
        assert adj.record_plan(scene, st, 2048, 2) == "recorded"
        before = counts()
        l_rec, g_rec = render_loss_grad(params, scene, cam, st, target, 1)
        assert tuple(a - b for a, b in zip(counts(), before)) == (2, 2, 0, 2)
        adj.RECORD_BUDGET = live0 + one
        assert adj.record_plan(scene, st, 2048, 2) == "rerecord"
        before = counts()
        l_re, g_re = render_loss_grad(params, scene, cam, st, target, 1)
        assert tuple(a - b for a, b in zip(counts(), before)) == (4, 2, 0, 2)
        assert mk.live_record_bytes(cuda_device) == live0
    finally:
        adj.RECORD_BUDGET = saved
    assert torch.equal(l_rec, l_re)
    for f in FLOAT_MATERIAL_FIELDS:
        assert torch.equal(getattr(g_rec["materials"], f),
                           getattr(g_re["materials"], f)), f
    assert float(g_rec["materials"].albedo.abs().sum()) > 0
    if env:
        for a, b in zip(g_rec["env_mips"], g_re["env_mips"]):
            assert torch.equal(a, b)
        assert float(g_rec["env_mips"][0].abs().sum()) > 0
