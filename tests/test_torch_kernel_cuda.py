"""The CUDA megakernel vs its plain PyTorch version on the card: the
opaque variant (B1a) on Cornell glossy, the medium-stack variant (B1b) on
the glass-in-glass box, the envmap variants (B1c) with the sky shaded
after the kernel, with and without env NEE, and the BVH tier (B1d) on the
glass dragon, on a dragon under the sky with env NEE and on a strip
whose walks keep 19 entries on the stack; the area-light NEE variants
(B1e) on both tiers, with glass and with env NEE, and their light-NEE
probes on both tiers; and the world-BVH
traversal kernel (B3) against its plain version, with every
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
    with pytest.raises(NotImplementedError, match="fused tiers' caps"):
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


def _blocked_plate(cells=1):
    """tests/test_light_nee.py:74-92: a dark plate between the floor and
    the Cornell box's panel, as cells x cells quads (2 * cells^2
    triangles: 9 cells put the scene on the BVH tier, B1e+d)."""
    s = cornell.cornell_box(with_spheres=False)
    g = np.linspace(-0.5, 0.5, cells + 1, dtype=np.float32)
    v = np.array([(x, 0.2, z) for z in g for x in g], np.float32)
    q = [(r * (cells + 1) + c, r * (cells + 1) + c + 1,
          (r + 1) * (cells + 1) + c + 1, (r + 1) * (cells + 1) + c)
         for r in range(cells) for c in range(cells)]
    f = np.array([t for a, b, c, d in q for t in ((a, b, c), (a, c, d))],
                 np.int32)
    s.add_mesh(v, f, cornell.Material.diffuse((0.1, 0.1, 0.1)))
    return s


# B1e: name -> (scene builder, camera, settings beyond light NEE at 32x32
# and 2 spp)
LIGHT_CASES = {
    "cornell": (lambda: cornell.cornell_box(), CAM, dict(max_bounces=4)),
    "cornell_prng_no_rr": (lambda: cornell.cornell_box(glossy=True), CAM,
                           dict(max_bounces=4, sampler=ht.SamplerKind.PRNG,
                                russian_roulette=False)),
    "glow_orbs": (lambda: cornell.glow_orbs(), CAM, dict(max_bounces=4)),
    "blocked_plate": (_blocked_plate, CAM, dict(max_bounces=2)),
    "glass_box": (lambda: cornell.glass_sphere_box(), CAM,
                  dict(max_bounces=8, max_transmission_bounces=8)),
    "sky_env_light": (lambda: cornell.cornell_box(glossy=True), CAM,
                      dict(max_bounces=4, use_envmap=True,
                           env_importance_sampling=True, env_mip_level=0)),
    "glass_sky_env_light": (lambda: cornell.glass_sphere_box(), CAM,
                            dict(max_bounces=8, max_transmission_bounces=8,
                                 use_envmap=True,
                                 env_importance_sampling=True,
                                 env_mip_level=0)),
    "glass_dragon": (lambda: meshes.glass_dragon_scene(), DRAGON_CAM,
                     dict(max_bounces=12)),
    "blocked_plate_bvh": (lambda: _blocked_plate(9), CAM,
                          dict(max_bounces=2)),
    "dragon_sky_env_light": (lambda: meshes.glass_dragon_scene(tris=1280),
                             DRAGON_CAM,
                             dict(max_bounces=4, use_envmap=True,
                                  env_importance_sampling=True,
                                  env_mip_level=0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LIGHT_CASES))
def test_light_nee_kernel_matches_plain_on_card(name, cuda_device):
    """B1e on the brute tier (the Cornell panel, the Glow Orbs' sphere
    emitters, a blocked panel, glass, env NEE and light NEE together) and
    on the BVH tier (B1e+d: the glass dragon, the blocked plate as 162
    triangles, whose shadow rays the any-hit walk stops at the plate, and
    a dragon under the sky with both NEEs), against the lockstep's light
    NEE. With env NEE the
    final direction and the continuation pdf are held where and as the sky
    pass reads them (`as_read`): Cornell glossy's 0.1-roughness metal
    sphere has the near-mirror lobe whose pdf amplifies an ulp of
    direction (5 of 2,048 raw pdfs outside rtol 1e-2 on an H100)."""
    make, cam_kw, kw = LIGHT_CASES[name]
    sky = Envmap.gradient_sky() if kw.get("use_envmap") else None
    scene = make().build(envmap=sky, device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                           light_importance_sampling=True, **kw)
    assert scene.lights is not None and mk.fused_supported(scene, st)
    bvh = mk.uses_bvh(scene)
    assert bvh == (name.startswith(("glass_dragon", "dragon"))
                   or name.endswith("_bvh"))
    if bvh:
        st = st.replace(width=64, height=64)
    got = _check_kernel_vs_plain(scene, cam_kw, st, cuda_device,
                                 as_read=bvh or st.env_importance_sampling)
    assert got.shape[1] == (mk.N_OUTPUTS_NEE if st.env_importance_sampling
                            else mk.N_OUTPUTS)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["blocked_plate_bvh", "glass_dragon"])
def test_light_probe_counts_both_walks(name, cuda_device):
    """The light-NEE probe (`megakernel.light_probe`) on B1e+d (the blocked
    plate) and B1b+e+d (the glass dragon): letting the any-hit walk decide
    it gives the kernel's outputs bit for bit; letting the closest-hit
    walk decide (the rule before the any-hit walk) it gives the same
    outputs but on rays where the two decisions differed, each of which
    it counts; the two walks count the same shadow rays, the blocked ones
    among them, and their tests."""
    make, cam_kw, kw = LIGHT_CASES[name]
    scene = make().build(device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                           light_importance_sampling=True, **kw)
    assert mk.uses_bvh(scene)
    cam = ht.make_camera(**cam_kw, device=cuda_device)
    pix = torch.arange(st.num_pixels, device=cuda_device).repeat_interleave(2)
    lane = torch.arange(2, device=cuda_device).repeat(st.num_pixels)
    sidx = sob.sample_index(1, lane, st.samples_per_pixel)
    seed = sob.pixel_seed(pix)
    o, d = generate_rays(cam, pix % st.width, pix // st.width, st.width,
                         st.height, st.filter_radius, sidx, seed,
                         _sampler_2d(st))
    out = mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st)
    out_any, c_any = mk.light_probe(scene, o, d, cam.far, sidx, seed, st,
                                    "kernel")
    out_old, c_old = mk.light_probe(scene, o, d, cam.far, sidx, seed, st,
                                    "closest")
    torch.cuda.synchronize()
    assert torch.equal(out_any, out)
    apart = (out_old != out).any(dim=1)
    col = {k: i for i, k in enumerate(mk.PROBE_COUNTERS)}
    assert bool((c_old[apart, col["decisions_differ"]] > 0).all())
    tot = c_any.sum(dim=0)
    assert int(tot[col["shadow_rays"]]) > 0
    assert int(tot[col["blocked"]]) > 0
    assert int(tot[col["tri_tests_kernel"]]) > 0
    assert int(tot[col["tris_culled"]]) == 0
    assert int(tot[col["tri_tests_closest"]]) > 0
    same = ~apart
    assert torch.equal(c_any[same, :2], c_old[same, :2])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "glow_orbs", "blocked_plate",
                                  "glass_box"])
def test_brute_light_probe_equals_kernel(name, cuda_device):
    """The brute tier's light-NEE probe (`megakernel.light_probe` on B1e,
    and on B1b+e in the glass box) at 64x64 pixels x 4 lanes: deciding by
    the closest-hit rule over every triangle (B1e's rule before the cull)
    and deciding by the culled scan (B1e's) it gives the kernel's outputs
    bit for bit, the two decisions never apart; the culled scan skips
    triangles and runs fewer Möller-Trumbore tests than the full one; with
    no test every draw is visible."""
    make, cam_kw, kw = LIGHT_CASES[name]
    scene = make().build(device=cuda_device)
    st = ht.RenderSettings(width=64, height=64, samples_per_pixel=4,
                           light_importance_sampling=True, **kw)
    assert not mk.uses_bvh(scene)
    cam = ht.make_camera(**cam_kw, device=cuda_device)
    pix = torch.arange(st.num_pixels, device=cuda_device).repeat_interleave(4)
    lane = torch.arange(4, device=cuda_device).repeat(st.num_pixels)
    sidx = sob.sample_index(1, lane, st.samples_per_pixel)
    seed = sob.pixel_seed(pix)
    o, d = generate_rays(cam, pix % st.width, pix // st.width, st.width,
                         st.height, st.filter_radius, sidx, seed,
                         _sampler_2d(st))
    out = mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st)
    probe = {m: mk.light_probe(scene, o, d, cam.far, sidx, seed, st, m)
             for m in ("closest", "kernel", "no test")}
    torch.cuda.synchronize()
    col = {k: i for i, k in enumerate(mk.PROBE_COUNTERS)}
    for m in ("closest", "kernel"):
        got, counts = probe[m]
        assert torch.equal(got, out), m
        assert int(counts[:, col["decisions_differ"]].sum()) == 0, m
    tot = probe["kernel"][1].sum(dim=0)
    rays = int(tot[col["shadow_rays"]])
    assert rays > 0
    assert int(tot[col["tri_tests_closest"]]) == rays * scene.num_triangles
    assert (int(tot[col["tri_tests_kernel"]]) + int(tot[col["tris_culled"]])
            == rays * scene.num_triangles)
    assert int(tot[col["tris_culled"]]) > 0
    assert int(tot[col["box_tests_closest"]]) == 0
    assert int(tot[col["box_tests_kernel"]]) == int(tot[col["ties"]]) == 0
    if name == "blocked_plate":
        assert int(tot[col["blocked"]]) > 0
    none = probe["no test"][1].sum(dim=0)
    assert int(none[col["shadow_rays"]]) > 0
    assert int(none[col["blocked"]]) == 0


@pytest.mark.cuda
def test_light_nee_frame_and_step_launch_the_kernels(cuda_device):
    """A light-NEE frame on the card is one B1e launch a group (no plain
    version on the main path); its fwd+bwd step is one recording B1e and
    one B2+l sweep a group (no replay), whose material gradients agree
    with `Fused.OFF`'s autograd through the lockstep (1e-3 of each
    column's largest + 1e-6; the cotangent is zero on the pixels whose
    forwards part past 1e-4); `fit_materials` runs; a step whose records
    pass the budget while one launch's fits takes the route that records
    each group again in its backward (a plain B1e a group forward, a
    recording B1e and a sweep a group backward), with the record route's
    bits, and `fit_materials` takes it too; and a budget below one
    launch's record raises before any launch."""
    from halogen_tpu_torch.diff import fit_materials, render_loss_grad
    from halogen_tpu_torch.kernels import adjoint as adj

    scene = cornell.cornell_box().build(device=cuda_device)
    cam = ht.make_camera(**CAM, device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=4,
                           max_bounces=4, ray_chunk_size=2048,
                           light_importance_sampling=True)
    before = mk.LAUNCHES
    img = ht.render_frame(scene, cam, st, 1)
    assert mk.LAUNCHES - before == 2
    plain = ht.render_frame(scene, cam, st.replace(fused=ht.Fused.OFF), 1)
    img_n, plain_n = img.cpu().numpy(), plain.cpu().numpy()
    bad = (np.abs(img_n - plain_n) > 1e-4 + 1e-4 * np.abs(plain_n)).any(
        axis=-1)
    assert bad.sum() <= 1
    # the target: the frame itself on the pixels where the forwards agree,
    # so those pixels give both routes one cotangent (zero elsewhere)
    keep = torch.from_numpy(~bad).to(cuda_device)[..., None]
    target = torch.where(keep, img * 0.5, img)
    counts = lambda: (mk.LAUNCHES, mk.RECORD_LAUNCHES, adj.LAUNCHES,
                      adj.SWEEP_LAUNCHES)
    before = counts()
    _, g_k = render_loss_grad({"materials": scene.materials}, scene, cam,
                              st, target, 1)
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 2, 0, 2)
    _, g_p = render_loss_grad({"materials": scene.materials}, scene, cam,
                              st.replace(fused=ht.Fused.OFF), target, 1)
    for f in ("albedo", "specular", "emissive", "absorption"):
        a, b = (getattr(g["materials"], f).cpu().numpy() for g in (g_k, g_p))
        assert np.isfinite(a).all()
        bound = 1e-3 * np.abs(b).max(axis=0) + 1e-6
        assert (np.abs(a - b) <= bound).all(), (f, np.abs(a - b).max())
    assert np.abs(g_k["materials"].emissive.cpu().numpy()).max() > 0
    _, losses = fit_materials(scene, cam, st, target, steps=2)
    assert np.isfinite(losses).all()
    saved = adj.RECORD_BUDGET
    one = adj.record_bytes(scene, st, 2048)
    adj.RECORD_BUDGET = mk.live_record_bytes(cuda_device) + one
    try:
        before = counts()
        _, g_r = render_loss_grad({"materials": scene.materials}, scene,
                                  cam, st, target, 1)
        assert tuple(a - b for a, b in zip(counts(), before)) == (
            4, 2, 0, 2)
        for f in ("albedo", "specular", "emissive", "absorption"):
            assert torch.equal(getattr(g_r["materials"], f),
                               getattr(g_k["materials"], f)), f
        before = counts()
        _, losses = fit_materials(scene, cam, st, target, steps=2)
        assert np.isfinite(losses).all()
        assert tuple(a - b for a, b in zip(counts(), before)) == (
            8, 4, 0, 4)
        adj.RECORD_BUDGET = 1
        before = counts()
        with pytest.raises(NotImplementedError, match="ray_chunk_size"):
            render_loss_grad({"materials": scene.materials}, scene, cam, st,
                             target, 1)
        assert counts() == before
    finally:
        adj.RECORD_BUDGET = saved


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


def _strip_camera_rays(cam, st, dev):
    pix = torch.arange(st.num_pixels, device=dev)
    sidx = sob.sample_index(1, torch.zeros_like(pix), st.samples_per_pixel)
    seed = sob.pixel_seed(pix)
    o, d = generate_rays(cam, pix % st.width, pix // st.width, st.width,
                         st.height, st.filter_radius, sidx, seed,
                         _sampler_2d(st))
    return o, d


@pytest.mark.cuda
def test_traverse_deep_stack_on_card(cuda_device):
    """B3 on the deep strip (`meshes.deep_strip_scene`, max_leaf=1), whose
    camera rays leave 19 far children pending on the walk's stack (a ray
    beside triangle 0 finds triangle 1, at x = 1.15, in the 19th entry):
    the kernel equals its plain version (t, u, v at 1e-5, the same
    triangles)."""
    scene = meshes.deep_strip_scene().build(max_leaf=1, device=cuda_device)
    cam = ht.make_camera(**meshes.STRIP_CAM, device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=1)
    o, d = _strip_camera_rays(cam, st, cuda_device)
    seed = torch.full((o.shape[0],), float("inf"), device=cuda_device)
    got = [x.cpu().numpy() for x in traverse.traverse_world(scene.wbvh, o, d,
                                                            seed)]
    ref = [x.cpu().numpy() for x in traverse.traverse_world_reference(
        scene.wbvh, o, d, seed)]
    np.testing.assert_array_equal(np.isinf(got[0]), np.isinf(ref[0]))
    hit = np.isfinite(ref[0])
    assert hit.mean() > 0.5  # the cone's corners pass beside the strip
    for i in (0, 2, 3):
        np.testing.assert_allclose(got[i][hit], ref[i][hit], atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_array_equal(got[1], ref[1])
    hit_x = (o[:, 0] + torch.from_numpy(ref[0]).to(o) * d[:, 0]).cpu()
    assert bool((torch.abs(hit_x - 1.15) < 1e-3).any())  # triangle 1
    assert (got[6][hit] > 32).all()  # deep walks


@pytest.mark.cuda
def test_bvh_kernel_deep_stack_matches_plain_on_card(cuda_device):
    """B1d on the deep strip under the sky with env NEE (B1c+d): the
    camera rays' walks keep 19 entries on the stack; the kernel agrees
    with its plain version as the other B1d scenes do."""
    scene = meshes.deep_strip_scene().build(
        envmap=Envmap.gradient_sky(), max_leaf=1, device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=2,
                           max_bounces=4, use_envmap=True,
                           env_importance_sampling=True, env_mip_level=0)
    assert mk.uses_bvh(scene)
    _check_kernel_vs_plain(scene, meshes.STRIP_CAM, st, cuda_device,
                           as_read=True)


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
    the kernel route (it raised before the adjoint's BVH tier) is one
    launch of B2b+d a group, with finite gradients: on the record route
    the forward records the transcript and the backward is the sweep
    alone, no replay."""
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
    from halogen_tpu_torch.kernels import adjoint as adj

    b, s, r = adj.LAUNCHES, adj.SWEEP_LAUNCHES, mk.RECORD_LAUNCHES
    loss, grads = render_loss_grad(
        {"materials": scene.materials}, scene, cam, st,
        torch.zeros((16, 16, 3), device=cuda_device), 1)
    assert (mk.RECORD_LAUNCHES - r, adj.SWEEP_LAUNCHES - s,
            adj.LAUNCHES - b) == (1, 1, 0)
    assert bool(torch.isfinite(loss))
    assert bool(torch.isfinite(grads["materials"].albedo).all())
    assert float(grads["materials"].absorption.abs().max()) > 0


# --- launches from pixels, and warps that refill

def _pixel_scenes(dev):
    """B1a, B1b, B1c and a B1d variant: (scene, camera, settings)."""
    sky = Envmap.gradient_sky()
    small = dict(width=48, height=32, samples_per_pixel=8)
    glass = dict(max_bounces=8, max_transmission_bounces=8)
    return {
        "B1a": (cornell.cornell_box(glossy=True).build(device=dev),
                ht.make_camera(**CAM, aspect=1.5, device=dev),
                ht.RenderSettings(**small, max_bounces=4)),
        # a thin lens
        "B1b": (cornell.glass_sphere_box().build(device=dev),
                ht.make_camera(**CAM, aspect=1.5, aperture_deg=2.0,
                               focal_distance=3.2, device=dev),
                ht.RenderSettings(**small, **glass)),
        "B1c": (cornell.material_demo_spheres().build(envmap=sky, device=dev),
                ht.make_camera(**SKY_CAM, aspect=1.5, device=dev),
                ht.RenderSettings(**small, max_bounces=4, use_envmap=True,
                                  env_importance_sampling=True,
                                  env_mip_level=0,
                                  sampler=ht.SamplerKind.PRNG)),
        "B1b+d": (meshes.glass_dragon_scene().build(device=dev),
                  ht.make_camera(position=(0, 1.5, 5), target=(0, -0.3, 0),
                                 fov_deg=45, aspect=1.5, device=dev),
                  ht.RenderSettings(**small, max_bounces=12)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("n_pix", [1000, 150001])
@pytest.mark.parametrize("name", ["B1a", "B1b", "B1c", "B1b+d"])
def test_pixel_launch_equals_explicit_ray_launch(name, n_pix, cuda_device):
    """The kernel's own rays against `group_rays` on the card (integers
    bit for bit; floats within 1e-6: the ops are `generate_rays`', but a
    `logf`, `sinf` or `cosf` or the camera transform's GEMM may round an
    ulp apart from torch's), and the launch from pixels against the
    explicit-ray launch on the rays it wrote, outputs bit for bit: at a
    ray count under the persistent grid, and at one over it (300,002: the
    pixels repeat), where lanes that fall free make the later rays."""
    from halogen_tpu_torch.integrator.trace import group_rays

    scene, cam, st = _pixel_scenes(cuda_device)[name]
    rng = np.random.default_rng(3)
    pix = torch.from_numpy(rng.integers(0, st.num_pixels, n_pix)).to(
        cuda_device)
    frame, lane0, spp_block = 5, 4, 2
    view = mk.pixel_view(cam, st, frame, pix)
    before = mk.LAUNCHES
    out, o, d, sidx, seed = mk.trace_pixels_outputs(
        scene, view, lane0, spp_block, st, write_rays=True)
    quiet = mk.trace_pixels_outputs(scene, view, lane0, spp_block, st)
    explicit = mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st)
    assert mk.LAUNCHES == before + 3
    ro, rd, rsidx, rseed = group_rays(cam, st, frame, pix, lane0, spp_block)
    torch.cuda.synchronize()
    assert torch.equal(sidx, mk._as_i32(rsidx))
    assert torch.equal(seed, mk._as_i32(rseed))
    assert float((o - ro).abs().max()) <= 1e-6
    assert float((d - rd).abs().max()) <= 1e-6
    assert torch.equal(out, explicit)
    assert torch.equal(out, quiet)
    # the frame as a device tensor gives the same launch
    view_t = mk.pixel_view(cam, st, torch.tensor([frame], device=cuda_device),
                           pix)
    assert torch.equal(out, mk.trace_pixels_outputs(scene, view_t, lane0,
                                                    spp_block, st))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 262144 + 5])
def test_refilling_launch_matches_plain(n, cuda_device):
    """Warps that refill, at ragged ray counts and at counts smaller and
    larger than the grid: equal to the one-ray-a-thread order bit for bit,
    and to the plain version at the kernel's tolerance."""
    st = ht.RenderSettings(width=512, height=512, samples_per_pixel=2,
                           max_bounces=4)
    scene = cornell.glass_sphere_box().build(device=cuda_device)
    cam = ht.make_camera(**CAM, device=cuda_device)
    pix = torch.arange(n, device=cuda_device) % st.num_pixels
    lane = torch.arange(n, device=cuda_device) // st.num_pixels
    sidx = sob.sample_index(1, lane, st.samples_per_pixel)
    seed = sob.pixel_seed(pix)
    o, d = generate_rays(cam, pix % st.width, pix // st.width, st.width,
                         st.height, st.filter_radius, sidx, seed,
                         _sampler_2d(st))
    got = mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st)
    threads = mk._launch(scene, o, d, cam.far, sidx, seed, st, None,
                         refill=False)
    torch.cuda.synchronize()
    assert torch.equal(got, threads)
    m = min(n, 4096)  # the plain version on the first rays
    ref = mk.trace_color_fused_reference(scene, o[:m], d[:m], cam.far,
                                         sidx[:m], seed[:m], st)
    a, b = got[:m].cpu().numpy(), ref.cpu().numpy()
    bad = (np.abs(a - b) > 1e-4 + 1e-4 * np.abs(b)).any(axis=1)
    assert np.isfinite(got.cpu().numpy()).all()
    assert bad.sum() <= max(1, m // 1000), bad.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("glass", [False, True])
def test_grad_with_in_kernel_rays_equals_explicit_rays(glass, cuda_device):
    """`render_loss_grad` through launches from pixels (the chunk node of
    the record route) against the same groups with explicit rays (a node
    a group): the same [K, 12] bits, so the same gradients."""
    from halogen_tpu_torch.diff import render_loss_grad

    scene = (cornell.glass_sphere_box() if glass
             else cornell.cornell_box(glossy=True)).build(device=cuda_device)
    cam = ht.make_camera(**CAM, device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=4,
                           max_bounces=8 if glass else 4,
                           max_transmission_bounces=8, ray_chunk_size=2048)
    target = torch.zeros((32, 32, 3), device=cuda_device)
    params = {"materials": scene.materials}
    _, g_pix = render_loss_grad(params, scene, cam, st, target, 3)

    def explicit(sc, view, lane0, spp_block, settings, tables=None,
                 env_tab=None, light_tab=None, record=None):
        # the rays as the kernel makes them (its written-out rays), then
        # the explicit-ray route
        _, o, d, sidx, seed = mk.trace_pixels_outputs(
            sc, view, lane0, spp_block, settings, write_rays=True,
            light_tab=light_tab)
        return mk.trace_color_fused_diff(sc, o, d, view.camera.far, sidx,
                                         seed, settings, tables, env_tab,
                                         light_tab, record)

    saved = mk.trace_color_pixels_diff, mk.chunk_serves
    mk.trace_color_pixels_diff = explicit
    mk.chunk_serves = lambda *args: False
    try:
        _, g_exp = render_loss_grad(params, scene, cam, st, target, 3)
    finally:
        mk.trace_color_pixels_diff, mk.chunk_serves = saved
    for f in ("albedo", "specular", "emissive", "absorption"):
        a, b = getattr(g_pix["materials"], f), getattr(g_exp["materials"], f)
        assert torch.equal(a, b), f
    assert float(g_pix["materials"].albedo.abs().sum()) > 0
