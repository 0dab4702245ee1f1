"""The adjoint's record route on the CPU: the transcript a forward records
(`adjoint.record_transcript_reference`, the lockstep's transcript in the
kernel's `megakernel.Record` layout), the sweep over it
(`adjoint.sweep_reference`, the plain version of `csrc/adjoint.cu`
`adjoint_sweep`), and the rule that picks the route (`adjoint.record_plan`).

The sweep of the lockstep's transcript must give the [K, 12|13] of
autograd through the port's lockstep (`trace_grad_outputs_reference`)
within 1e-5 * max |column| + 1e-7, and the material gradients of
`jax.grad` through the JAX lockstep `trace_rays` (what the JAX package's
big-scene backward runs, `halogen_tpu/kernels/megakernel.py:1953-1975`)
at atol 1e-6, rtol 1e-5, as `tests/test_torch_grad_big.py` holds them: the
two sweeps and autograd sum the same products in other orders. Both tiers
record. The BVH tier's scenes (over 128 triangles): a 1,280-triangle metal
dragon in the Cornell shell (B2+d), the glass dragon at 1,280 triangles
(B2b+d), the metal dragon under the gradient sky (B2c+d) and with env NEE
(B2c+n+d), and a grey dragon in a grey shell, whose attenuations tie in
Russian roulette's max. The brute tier's: Cornell glossy (B2), the glass
box at 8 bounces (B2b), Cornell glossy under the sky (B2c) and the
material spheres under the sky with env NEE (B2c+n, the `envmap_1024`
preset's scene). With area-light NEE (B2+l, whose record also holds the
emission's weight and the light term): the Cornell box (a triangle
light), `glow_orbs` (sphere lights, which few rays shade), the glass box,
Cornell glossy under the sky with env NEE and light NEE, and the metal
and glass dragons at 1,280 triangles. The kernels are held to these
plain versions on the card (`tests/test_torch_adjoint_cuda.py`,
`chip_smoke.py` phases 28, 30, 31, 35, 36).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)
import torch

import halogen_tpu as jht
from halogen_tpu.config import Intersector as JIntersector
from halogen_tpu.integrator.camera import generate_rays as j_generate_rays
from halogen_tpu.integrator.trace import trace_rays as j_trace_rays
from halogen_tpu.sampler import sobol as jsob
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene import meshes as jmeshes
from halogen_tpu.scene.envmap import Envmap as JEnvmap
from halogen_tpu.scene.material import Material as JMaterial
from halogen_tpu_torch import interop
from halogen_tpu_torch.config import RenderSettings
from halogen_tpu_torch.diff.grad import FLOAT_MATERIAL_FIELDS
from halogen_tpu_torch.integrator.trace import deferred_sky
from halogen_tpu_torch.kernels import adjoint as adj
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.scene.envmap import Envmap as TEnvmap

CPU = "cpu"  # the port builds on the card unless asked for the CPU
DRAGON_CAM = dict(position=(0, 1.5, 5.0), target=(0, -0.3, 0), fov_deg=45)
BOX_CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
# the envmap_nee golden's camera (scripts/gen_goldens.py:66-67)
SKY_CAM = dict(position=(0, 1.0, 6.0), target=(0, 0.5, 0), fov_deg=40)
W, LANES = 12, 2
ATOL, RTOL = 1e-6, 1e-5  # tests/test_torch_grad_big.py
SKY = dict(use_envmap=True)
NEE = dict(use_envmap=True, env_importance_sampling=True, env_mip_level=0)
GLASS8 = dict(max_bounces=8, max_transmission_bounces=8)
# The held cases against jax.grad. On a few of their rays the port's
# lockstep forward and the JAX package's jitted one round the color apart
# (Cornell glossy under the sky: 1 ray of 288 by 7.7e-5 relative; the
# spheres with env NEE: 4 rays past 1e-6; glow_orbs: 1; Cornell glossy
# with both NEEs: 5). Run op by op (`jax.disable_jit`), the JAX lockstep
# agrees with the port within 1e-6 on every ray of the four cases: the
# rays part where XLA's CPU compiler contracts a * b + c into a fused
# multiply-add. On each of them the first value apart is a sphere hit's t,
# from the sphere test's b = 2 * dot(oc, direction)
# (`halogen_tpu/core/math.py` `sphere_intersect`), whose products XLA adds
# as fma(oc_z, d_z, fma(oc_y, d_y, oc_x * d_x)) (and its discriminant
# b * b - 4 c as fma(b, b, -4 c)) while the port, like the kernels
# (`-fmad=false`), rounds each (`test_xla_contracts_the_sphere_tests_dot_
# product`); on a grazing hit that moves t by ~1e-6 and the
# normal by ~5e-5, and a near-mirror lobe's pdf or an NEE weight grows it;
# or (one ray of Cornell glossy with both NEEs, one of glow_orbs) a value
# of the NEE terms, the same contraction elsewhere. Through such a ray the
# gradient differs from jax.grad by up to 18.8x atol + rtol |entry|
# (roughness, B2c), and in glow_orbs a ray whose color agrees within 1e-6
# (a grazing sphere hit, ray 82) moves an albedo entry by 8.2e-5 of 0.687.
# So these cases give a zero cotangent to the rays whose colors part by
# more than 1e-6 + 1e-6 |JAX| (at most 5% of the rays), and hold each
# column to ATOL + RTOL * its largest |entry|; their per-material sums
# also cancel (an entry of ~0.19 from terms of up to ~12). Three more
# glow_orbs rays parted (up to 2.8e-5) because torch's float32 sqrt on the
# CPU misses the correctly rounded root by an ulp on ~0.6% of inputs (a
# sphere light's cone, cos_max); the port's plain versions take a
# correctly rounded one (`core/math.py` `sqrt`), as XLA and the kernels'
# sqrtf do (`test_cpu_sqrt_is_correctly_rounded`).
HELD_WHERE_FORWARDS_AGREE = ("B2c", "B2c+n", "B2+l_orbs", "B2c+n+l")
LIGHT = dict(light_importance_sampling=True)
# name: (scene, sky, settings, camera); the names ending in +d (and
# rr_ties) are the BVH tier's, the others the brute tier's
CASES = {
    "B2+d": ("metal", False, {}, DRAGON_CAM),
    "B2b+d": ("glass", False, dict(max_transmission_bounces=6), DRAGON_CAM),
    "B2c+d": ("metal", True, SKY, DRAGON_CAM),
    "B2c+n+d": ("metal", True, NEE, DRAGON_CAM),
    "rr_ties": ("grey", False, {}, DRAGON_CAM),
    "B2": ("cornell", False, {}, BOX_CAM),
    "B2b": ("glass_box", False, GLASS8, BOX_CAM),
    "B2c": ("cornell", True, SKY, BOX_CAM),
    "B2c+n": ("spheres", True, NEE, SKY_CAM),
    # area-light NEE (B2+l) on both tiers
    "B2+l": ("cornell_box", False, LIGHT, BOX_CAM),
    "B2+l_orbs": ("glow_orbs", False, LIGHT, BOX_CAM),
    "B2b+l": ("glass_box", False, {**GLASS8, **LIGHT}, BOX_CAM),
    "B2c+n+l": ("cornell", True, {**NEE, **LIGHT}, BOX_CAM),
    "B2+l+d": ("metal", False, LIGHT, DRAGON_CAM),
    "B2b+l+d": ("glass", False, dict(max_transmission_bounces=6, **LIGHT),
                DRAGON_CAM),
}


def _grey_shell():
    """The Cornell box's floor, ceiling, back wall and light, all grey: a
    path's attenuation keeps three equal channels, so Russian roulette's
    max ties on every bounce."""
    s = jht.Scene()
    white = JMaterial.diffuse((0.73, 0.73, 0.73))
    for quad in ([(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)],
                 [(-1, 1, -1), (-1, 1, 1), (1, 1, 1), (1, 1, -1)],
                 [(-1, -1, -1), (-1, 1, -1), (1, 1, -1), (1, -1, -1)]):
        jcornell._quad(s, quad, white)
    jcornell._quad(s, [(-0.4, 0.995, -0.4), (-0.4, 0.995, 0.4),
                       (0.4, 0.995, 0.4), (0.4, 0.995, -0.4)],
                   JMaterial.emissive((1.0, 1.0, 1.0), 10.0))
    return s


def _dragon_box(material, grey=False):
    s = _grey_shell() if grey else jcornell.cornell_box(with_spheres=False)
    verts, faces = jmeshes.dragon_mesh(3)
    s.add_mesh(verts, faces, material,
               transform=jmeshes._scale_translate(0.55, (0.0, -0.45, 0.0)))
    return s


def _jax_scene(kind, sky):
    env = JEnvmap.gradient_sky() if sky else None
    if kind == "cornell":
        return jcornell.cornell_box(glossy=True).build(envmap=env)
    if kind == "cornell_box":
        return jcornell.cornell_box().build(envmap=env)
    if kind == "glow_orbs":
        return jcornell.glow_orbs().build(envmap=env)
    if kind == "glass_box":
        return jcornell.glass_sphere_box().build(envmap=env)
    if kind == "spheres":
        return jcornell.material_demo_spheres().build(envmap=env)
    if kind == "glass":
        return jmeshes.glass_dragon_scene(tris=1280).build(envmap=env)
    if kind == "grey":
        return _dragon_box(JMaterial.metal((0.7, 0.7, 0.7), roughness=0.4),
                           grey=True).build(envmap=env)
    return _dragon_box(JMaterial.metal((0.9, 0.6, 0.5), roughness=0.4)
                       ).build(envmap=env)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return _make_case(request.param)


def _make_case(name):
    """(name, JAX scene, its port, settings kwargs, rays as numpy with a
    cotangent of the outputs from a numpy seed)."""
    kind, sky, kw, cam_kw = CASES[name]
    js = _jax_scene(kind, sky)
    scene = interop.scene_from_numpy(interop.scene_to_numpy(js), device=CPU)
    cam = jht.make_camera(**cam_kw)
    pix = jnp.repeat(jnp.arange(W * W, dtype=jnp.int32), LANES)
    lane = jnp.tile(jnp.arange(LANES, dtype=jnp.uint32), W * W)
    seed = jsob.pixel_seed(pix.astype(jnp.uint32))
    sidx = jsob.sample_index(jnp.uint32(1), lane, 2)
    o, d = j_generate_rays(cam, pix % W, pix // W, W, W, 1.0, sidx, seed,
                           jsob.ld_sample_2d)
    n = W * W * LANES
    rng = np.random.default_rng(0)
    rays = dict(o=np.array(o), d=np.array(d), sidx=np.asarray(sidx),
                seed=np.asarray(seed), far=np.float32(np.asarray(cam.far)),
                ct=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
                gsky=rng.uniform(0.0, 1.0, (n, 4)).astype(np.float32))
    kw = {**dict(width=W, height=W, samples_per_pixel=LANES, max_bounces=6),
          **kw}
    return name, js, scene, kw, rays


def _port_rays(rays):
    return (torch.from_numpy(rays["o"]), torch.from_numpy(rays["d"]),
            torch.tensor(rays["far"]),
            torch.from_numpy(rays["sidx"].astype(np.int64)),
            torch.from_numpy(rays["seed"].astype(np.int64)))


def _assert_columns(got, ref):
    bound = 1e-5 * ref.abs().amax(dim=0) + 1e-7
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= bound).all(), (
        ((got - ref).abs() / bound).amax(dim=0))


def _rr_ties(scene, rec, st):
    """Russian-roulette decisions of the record whose attenuation's max
    ties over two or three channels (the max's cotangent splits)."""
    tab = mk._scene_tables(scene)[3]
    n_shaded = rec.end.to(torch.int64) & 0xFFFF
    ties = 0
    for k in range(st.max_bounces + 1):
        word = rec.word[k].to(torch.int64)
        live = (n_shaded > k) & ((word & (1 << 18)) != 0)
        m = tab[torch.where(live, word & 0xFF, 0)]
        spec = (word & (1 << 16)) != 0
        lobe = torch.where(spec[:, None], m[:, 4:7], m[:, 0:3])
        a_post = rec.a[k, :, 0:3] * lobe
        top = a_post.amax(dim=1, keepdim=True)
        ties += int((live & ((a_post == top).sum(dim=1) > 1)).sum())
    return ties


def test_sweep_of_the_record_matches_lockstep_autograd(case):
    """sweep_reference(record_transcript_reference(...)) against autograd
    through the port's lockstep, on the outputs' cotangent (the color's;
    with the sky also the miss attenuation's and roughness's)."""
    name, _, scene, kw, rays = case
    st = RenderSettings(**kw)
    bvh_tier = name.endswith("+d") or name == "rr_ties"
    assert mk.uses_bvh(scene) == bvh_tier and adj.adjoint_covers(scene, st)
    o, d, far, sidx, seed = _port_rays(rays)
    env = adj.env_mode(scene, st)
    d_out = torch.from_numpy(np.concatenate([rays["ct"], rays["gsky"]], 1))
    if not env:
        d_out[:, 3:] = 0.0  # no sky: the kernel reads the color's alone
    rec = adj.record_transcript_reference(scene, o, d, far, sidx, seed, st)
    n_shaded = rec.end.to(torch.int64) & 0xFFFF
    assert int(n_shaded.max()) >= 3 and int((n_shaded > 0).sum()) > 0
    got, records = adj.sweep_reference(scene, st, rec, d_out)
    ref, _ = adj.trace_grad_outputs_reference(scene, o, d, far, sidx, seed,
                                              d_out, st)
    assert got.shape == (scene.materials.count, adj.n_grad(scene, st))
    assert got[:, 0:6].abs().max() > 0
    _assert_columns(got, ref)
    if name in ("B2b+d", "B2b"):
        assert got[:, 9:12].abs().max() > 0  # Beer-Lambert's column
    if name == "rr_ties":
        assert _rr_ties(scene, rec, st) > 0
    if st.light_importance_sampling:  # light terms and MIS-weighted hits
        assert rec.lq is not None and int(_lit(rec).sum()) > 0
        assert float((rec.lq[..., 3] < 1.0).to(torch.float32).sum()) > 0
    assert (records is None) == (env != 2)
    if env == 2:  # the env-NEE records, summed per texel, give the mip's
        keys, weights = records
        assert int((keys >= 0).sum()) > 0
        h, w = scene.env_cdf.pdf.shape
        keep = keys.reshape(-1) >= 0
        sums = torch.zeros((h * w, 3), dtype=torch.float64).index_add_(
            0, keys.reshape(-1)[keep].to(torch.int64),
            weights.reshape(-1, 3)[keep].to(torch.float64))
        _, ref_env = adj.trace_grad_outputs_reference(
            scene, o, d, far, sidx, seed, d_out, st, want_env=True)
        ref_env = ref_env.reshape(-1, 3).to(torch.float64)
        assert float((sums - ref_env).abs().max()) <= (
            1e-5 * float(ref_env.abs().max()) + 1e-7)


def test_xla_contracts_the_sphere_tests_dot_product():
    """The op where the held cases part (see HELD_WHERE_FORWARDS_AGREE):
    on B2c's ray 90, a grazing hit on the metal sphere, the JAX sphere
    test jitted gives the t of b = 2 * dot(oc, d) with its products added
    by fused multiply-adds, fma(oc_z, d_z, fma(oc_y, d_y, oc_x * d_x)),
    and run op by op the t of every product and sum rounded, which is the
    port's t. Inside the jitted lockstep XLA also contracts the
    discriminant, b * b - 4 c as fma(b, b, -4 c): the ray's first hit is
    the t of both contractions."""
    from halogen_tpu.core import math as jmath
    from halogen_tpu_torch.core.math import sphere_intersect_soa

    _, js, _, _, rays = _make_case("B2c")
    o, d = rays["o"][90], rays["d"][90]
    c, r = (np.asarray(js.sphere_center)[1],
            np.asarray(js.sphere_radius)[1])
    f32 = np.float32

    def fma(a, b, x):  # exact product, one rounding to float32 of the sum
        return f32(np.float64(a) * np.float64(b) + np.float64(x))

    def t_of(b, oc, fused_disc=False):  # the rest of the test
        cq = f32(f32(f32(oc[0] * oc[0]) + f32(oc[1] * oc[1]))
                 + f32(oc[2] * oc[2])) - f32(r * r)
        disc = (fma(b, b, -f32(f32(4.0) * f32(cq))) if fused_disc
                else f32(f32(b * b) - f32(f32(4.0) * f32(cq))))
        return f32(f32(-b - f32(np.sqrt(disc))) * f32(0.5))

    oc = (o - c).astype(f32)
    p = [f32(oc[i] * d[i]) for i in range(3)]
    b_fused = f32(2.0) * fma(oc[2], d[2], fma(oc[1], d[1], p[0]))
    t_rounded = t_of(f32(2.0) * f32(f32(p[0] + p[1]) + p[2]), oc)
    t_fused = t_of(b_fused, oc)
    args = (o[None], d[None], c[None], r[None])
    t_jit = np.asarray(jax.jit(jmath.sphere_intersect)(*args)[0])[0]
    with jax.disable_jit():
        t_ops = np.asarray(jmath.sphere_intersect(*args)[0])[0]
    t_port = sphere_intersect_soa(
        *(tuple(torch.from_numpy(np.ascontiguousarray(v[None, i]))
                for i in range(3)) for v in (o, d, c)),
        torch.from_numpy(r[None]))[0].numpy()[0]
    assert t_jit == t_fused and t_ops == t_rounded == t_port
    assert abs(float(t_jit) - float(t_ops)) > 1e-6  # ~1.2e-6 of t
    st = jht.RenderSettings(width=W, height=W, samples_per_pixel=LANES,
                            max_bounces=0, use_envmap=True,
                            intersector=JIntersector.BRUTE)
    first = j_trace_rays(js, jnp.asarray(rays["o"][90:91]),
                         jnp.asarray(rays["d"][90:91]),
                         jnp.full((1,), rays["far"]),
                         jnp.asarray(rays["sidx"][90:91]),
                         jnp.asarray(rays["seed"][90:91]), st).first_hit_t
    assert np.asarray(first)[0] == t_of(b_fused, oc, fused_disc=True)


def test_cpu_sqrt_is_correctly_rounded():
    """The port's plain versions take square roots through `core.math.sqrt`,
    correctly rounded in float32 on the CPU as numpy's (IEEE 754), XLA's
    and the kernels' sqrtf are, on every input: among them glow_orbs' ray
    17's 1 - sin^2 of its sphere light's cone, where the JAX lockstep and
    the port parted by 2.8e-5 of the color before."""
    from halogen_tpu_torch.core.math import sqrt

    x = np.random.default_rng(0).uniform(0.0, 4.0, 1 << 20).astype(
        np.float32)
    x = np.concatenate([x, np.float32([0.9619861841201782, 0.0, 1.0])])
    got = sqrt(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.sqrt(x))


def _lit(rec):
    """[B + 1, N] whether each slot's light term was added (bit 27)."""
    n_shaded = rec.end.to(torch.int64) & 0xFFFF
    slot = torch.arange(rec.word.shape[0])[:, None]
    return (slot < n_shaded[None]) & (
        (rec.word.to(torch.int64) & (1 << 27)) != 0)


def _jax_color(js, kw, rays, mats=None):
    """The JAX lockstep tracer's color (brute force hits, as the port's
    plain backward pins)."""
    st = jht.RenderSettings(**kw, intersector=JIntersector.BRUTE)
    n = rays["o"].shape[0]
    sc = js if mats is None else dataclasses.replace(js, materials=mats)
    return j_trace_rays(sc, jnp.asarray(rays["o"]), jnp.asarray(rays["d"]),
                        jnp.full((n,), rays["far"]), jnp.asarray(rays["sidx"]),
                        jnp.asarray(rays["seed"]), st).color


def _jax_material_grads(js, kw, rays):
    """jax.grad of sum(color * ct) through the JAX lockstep tracer w.r.t.
    the materials."""
    def loss(mats):
        return jnp.sum(_jax_color(js, kw, rays, mats)
                       * jnp.asarray(rays["ct"]))

    g = jax.jit(jax.grad(loss, allow_int=True))(js.materials)
    return interop.material_table_to_numpy(g)


def test_sweep_of_the_record_matches_jax_grad(case):
    """The record route's plain halves against jax.grad through the JAX
    lockstep on the same numpy rays: with the sky, the sweep takes the
    cotangents that autograd of the port's sky pass gives the outputs."""
    name, js, scene, kw, rays = case
    st = RenderSettings(**kw)
    o, d, far, sidx, seed = _port_rays(rays)
    if name in HELD_WHERE_FORWARDS_AGREE:
        ref_col = np.asarray(_jax_color(js, kw, rays))
        col = deferred_sky(scene, st, mk.trace_color_fused_reference(
            scene, o, d, far, sidx, seed, st)).numpy()
        agree = (np.abs(col - ref_col) <= 1e-6 + 1e-6 * np.abs(ref_col)
                 ).all(axis=1)
        assert (~agree).sum() <= 0.05 * agree.shape[0], (~agree).sum()
        rays = dict(rays, ct=rays["ct"] * agree[:, None])
    ct = torch.from_numpy(rays["ct"])
    rec = adj.record_transcript_reference(scene, o, d, far, sidx, seed, st)
    d_out = torch.cat([ct, torch.zeros((ct.shape[0], 4))], dim=1)
    if adj.env_mode(scene, st):
        out = mk.trace_color_fused_reference(scene, o, d, far, sidx, seed,
                                             st).requires_grad_(True)
        g_out, = torch.autograd.grad((deferred_sky(scene, st, out)
                                      * ct).sum(), out)
        d_out = g_out[:, 0:7]
    dmat, _ = adj.sweep_reference(scene, st, rec, d_out)
    got = interop.material_table_to_numpy(
        adj.material_cotangents(scene, dmat))
    ref = _jax_material_grads(js, kw, rays)
    assert np.abs(ref["albedo"]).max() > 0
    for f in FLOAT_MATERIAL_FIELDS:
        if name in HELD_WHERE_FORWARDS_AGREE:
            bound = ATOL + RTOL * np.abs(ref[f]).max(axis=0)
            assert (np.abs(got[f] - ref[f]) <= bound).all(), (
                f, (np.abs(got[f] - ref[f]) / bound).max())
        else:
            np.testing.assert_allclose(got[f], ref[f], atol=ATOL, rtol=RTOL,
                                       err_msg=f)


GLASS_DRAGON_STEP = dict(width=512, height=512, samples_per_pixel=32,
                         max_bounces=12)


@pytest.fixture(scope="module")
def scenes():
    from halogen_tpu_torch.scene import cornell, meshes

    sky = TEnvmap.gradient_sky()
    return dict(
        dragon=meshes.glass_dragon_scene(tris=1280).build(device=CPU),
        cornell=cornell.cornell_box(glossy=True).build(device=CPU),
        glass_box=cornell.glass_sphere_box().build(device=CPU),
        spheres=cornell.material_demo_spheres().build(envmap=sky,
                                                      device=CPU),
        sky_dragon=meshes.glass_dragon_scene(tris=1280).build(
            envmap=TEnvmap.gradient_sky(), device=CPU))


# the share of an 80 GB card RECORD_SHARE gives
CARD_BUDGET = int(adj.RECORD_SHARE * 80e9)


@pytest.mark.parametrize("nee,light", [
    pytest.param(False, False, id="False"),
    pytest.param(True, False, id="True"),
    pytest.param(False, True, id="light"),
    pytest.param(True, True, id="True-light")])
def test_record_words_a_bounce(scenes, nee, light):
    """5 words a shaded bounce (a_prev rgb, t, the packed word), 12 with
    env NEE; with area-light NEE 4 more (the light term's f, dterm,
    gterm and the emission's weight): 9, or 16 with env NEE too; a ray's
    record is its slots and an end word."""
    sc = scenes["sky_dragon"]
    assert sc.lights is not None  # the Cornell shell's panel
    st = RenderSettings(**GLASS_DRAGON_STEP, **(NEE if nee else SKY),
                        light_importance_sampling=light)
    words = (12 if nee else 5) + (4 if light else 0)
    assert words in (5, 12, 9, 16)
    assert adj.record_words(sc, st) == words
    assert adj.record_bytes(sc, st, 262144) == 4 * 262144 * (
        1 + 13 * words)
    rec = mk.empty_record(7, st, nee, CPU, light)
    assert (rec.lq is not None) == light
    assert sum(t.numel() for t in rec if t is not None) == 7 * (
        1 + 13 * words)
    mk.check_record(rec, 7, st, nee, torch.device(CPU), light)


def test_record_plan_records_the_glass_dragon_step(scenes):
    """bench.py's glass dragon step (512x512, 32 spp, 12 bounces: 32
    launches of 262144 rays, 2.2 GB of records) takes the record route on
    an 80 GB card's share, and the replay past the budget."""
    sc, st = scenes["dragon"], RenderSettings(**GLASS_DRAGON_STEP)
    step = 32 * adj.record_bytes(sc, st, 262144)
    assert 2.1e9 < step < 2.3e9
    assert adj.record_plan(sc, st, 262144, 32, CARD_BUDGET) == "recorded"
    assert adj.record_plan(sc, st, 262144, 32, step) == "recorded"
    assert adj.record_plan(sc, st, 262144, 32, step - 1) == (
        adj.transcript_route(sc, st))
    assert adj.record_plan(sc, st, 262144, 32, 0) in ("shared", "global")
    # a 1024x1024 step of 256 spp: 4 chunks x 256 groups, ~71 GB
    assert adj.record_plan(sc, st.replace(width=1024, height=1024,
                                          samples_per_pixel=256),
                           262144, 1024, CARD_BUDGET) != "recorded"


def test_record_plan_follows_the_module_budget(scenes, monkeypatch):
    """Without an explicit budget the plan reads RECORD_BUDGET (set to 0
    it forces the replay, as chip_smoke.py phase 31 does); on a CPU scene
    with RECORD_BUDGET None the budget is 0: the plain versions run."""
    sc, st = scenes["dragon"], RenderSettings(**GLASS_DRAGON_STEP)
    monkeypatch.setattr(adj, "RECORD_BUDGET", CARD_BUDGET)
    assert adj.record_plan(sc, st, 262144, 32) == "recorded"
    monkeypatch.setattr(adj, "RECORD_BUDGET", 0)
    assert adj.record_plan(sc, st, 262144, 32) != "recorded"
    monkeypatch.setattr(adj, "RECORD_BUDGET", None)
    assert adj.record_budget(sc.device) == 0
    assert adj.record_plan(sc, st, 262144, 32) != "recorded"


def test_record_plan_counts_the_records_still_alive(scenes):
    """A step's plan counts the records of earlier forwards still alive on
    its device (a loss over several frames keeps every frame's records
    until its one backward): with a budget of one step's records, the
    plan replays while an earlier step's record lives and records again
    once it is freed."""
    sc, st = scenes["dragon"], RenderSettings(**GLASS_DRAGON_STEP)
    live0 = mk.live_record_bytes(CPU)
    step = 2 * adj.record_bytes(sc, st, 1024)
    budget = live0 + step
    assert adj.record_plan(sc, st, 1024, 2, budget) == "recorded"
    earlier = [mk.empty_record(1024, st, False, CPU) for _ in range(2)]
    assert mk.live_record_bytes(CPU) == live0 + step
    assert adj.record_plan(sc, st, 1024, 2, budget) == (
        adj.transcript_route(sc, st))
    assert adj.record_plan(sc, st, 1024, 2, budget + step) == "recorded"
    del earlier
    assert mk.live_record_bytes(CPU) == live0
    assert adj.record_plan(sc, st, 1024, 2, budget) == "recorded"


@pytest.mark.parametrize("why", ["brute_tier", "light_nee"])
def test_record_plan_replays_off_the_bvh_tier(scenes, why):
    """Off the BVH tier the brute tier records too: bench.py's Cornell
    256-spp step (64 launches of 262144 rays, 6 bounces) takes the record
    route on an 80 GB card's share, and a 1024x1024 step of 256 spp (1,024
    launches, ~38 GB of records) replays. Light NEE (B2+l) records on
    either tier, and never replays: past the budget each group's backward
    records its launch again ('rerecord'), and only a budget below one
    launch's record raises."""
    if why == "brute_tier":
        sc = scenes["cornell"]
        st = RenderSettings(width=256, height=256, samples_per_pixel=256,
                            max_bounces=6)
        assert not mk.uses_bvh(sc)
        assert adj.record_plan(sc, st, 262144, 64, CARD_BUDGET) == "recorded"
        big = st.replace(width=1024, height=1024)
        assert 38e9 < 1024 * adj.record_bytes(sc, big, 262144) < 39e9
        assert adj.record_plan(sc, big, 262144, 1024, CARD_BUDGET) == (
            adj.transcript_route(sc, big))
    else:
        for sc in (scenes["dragon"], scenes["cornell"]):
            st = RenderSettings(**GLASS_DRAGON_STEP,
                                light_importance_sampling=True)
            assert sc.lights is not None and adj.adjoint_covers(sc, st)
            assert adj.record_plan(sc, st, 262144, 1, CARD_BUDGET) == (
                "recorded")
            assert adj.record_plan(sc, st, 262144, 1024, CARD_BUDGET) == (
                "rerecord")
            with pytest.raises(NotImplementedError, match="ray_chunk_size"):
                adj.record_plan(sc, st, 262144, 1024,
                                adj.record_bytes(sc, st, 262144) - 1)


# bench.py's and the JAX CLI's brute-tier fwd+bwd steps: (scene, settings,
# launches of 262144 rays, GB of records)
BRUTE_STEPS = {
    "cornell_256spp": ("cornell", dict(width=256, height=256,
                                       samples_per_pixel=256, max_bounces=6),
                       64, 2.42),
    "glass_box_256spp": ("glass_box", dict(width=256, height=256,
                                           samples_per_pixel=256, **GLASS8),
                         64, 3.09),
    "envmap_1024": ("spheres", dict(width=1024, height=1024,
                                    samples_per_pixel=16, max_bounces=4,
                                    **NEE), 64, 4.09),
}


@pytest.mark.parametrize("step", sorted(BRUTE_STEPS))
def test_record_plan_records_the_brute_tier_steps(scenes, step):
    """The brute tier's full-width fwd+bwd steps keep their records within
    an 80 GB card's share (4 bytes a ray and 20 a slot, 48 with env NEE),
    so they take the record route; with RECORD_BUDGET's 0 they replay."""
    kind, kw, launches, gb = BRUTE_STEPS[step]
    sc, st = scenes[kind], RenderSettings(**kw)
    assert not mk.uses_bvh(sc)
    assert launches * 262144 == st.num_pixels * st.samples_per_pixel
    words = 12 if st.env_importance_sampling else 5
    one = adj.record_bytes(sc, st, 262144)
    assert one == 4 * 262144 * (1 + (st.max_bounces + 1) * words)
    assert abs(launches * one / 1e9 - gb) < 0.01
    assert adj.record_plan(sc, st, 262144, launches, CARD_BUDGET) == (
        "recorded")
    assert adj.record_plan(sc, st, 262144, launches, 0) == (
        adj.transcript_route(sc, st))


def test_wrappers_take_no_record_on_cpu(scenes):
    """On CPU tensors the differentiable entry points never record (the
    plain versions run), and the forward refuses, before any launch, a
    record without the light term's words under area-light NEE and one
    with them without it; the adjoint refuses a light-NEE replay (no
    replay kernel has light NEE)."""
    sc = scenes["cornell"]
    st = RenderSettings(max_bounces=2, light_importance_sampling=True)
    assert sc.lights is not None
    rays = (torch.zeros((4, 3)), torch.ones((4, 3)), torch.tensor(10.0),
            torch.zeros(4, dtype=torch.int64),
            torch.zeros(4, dtype=torch.int64))
    before = mk.LAUNCHES, adj.LAUNCHES, adj.SWEEP_LAUNCHES
    for rec, st_r in ((mk.empty_record(4, st, False, CPU), st),
                      (mk.empty_record(4, st, False, CPU, True),
                       st.replace(light_importance_sampling=False))):
        with pytest.raises(ValueError, match="record lq"):
            mk._launch(sc, *rays, st_r, None, record=rec)
    with pytest.raises(ValueError, match="no replay"):
        adj._launch(sc, *rays, torch.zeros((4, 3)), st, None,
                    route="shared")
    assert (mk.LAUNCHES, adj.LAUNCHES, adj.SWEEP_LAUNCHES) == before
    with pytest.raises(ValueError, match="needs the forward's record"):
        adj._launch(sc, None, None, None, None, None, torch.zeros((4, 3)),
                    st, None, route="recorded")


def test_light_nee_step_past_the_budget_records_again_in_its_backward(
        scenes):
    """Area-light NEE has no replay: a step whose records pass the budget
    takes the route that records each launch again in its backward
    ('rerecord'), where one launch's record fits beside those alive; where
    even that does not fit the plan raises NotImplementedError, naming
    that launch's bytes, the budget and `ray_chunk_size`, before any
    launch. bench.py's Cornell step with light NEE (256x256, 256 spp, 6
    bounces: 64 launches, 9 words a slot) keeps 4.29 GB; 1024x1024 at 256
    spp (1,024 launches) would keep 68.7 GB."""
    sc = scenes["cornell"]
    st = RenderSettings(width=256, height=256, samples_per_pixel=256,
                        max_bounces=6, light_importance_sampling=True)
    one = adj.record_bytes(sc, st, 262144)
    step = 64 * one
    assert step == 64 * 4 * 262144 * (1 + 7 * 9)
    assert 4.28e9 < step < 4.30e9 < CARD_BUDGET
    assert 68.6e9 < 1024 * one < 68.8e9
    live = mk.live_record_bytes(CPU)
    assert adj.record_plan(sc, st, 262144, 64, step + live) == "recorded"
    before = mk.LAUNCHES, adj.LAUNCHES, adj.SWEEP_LAUNCHES
    assert adj.record_plan(sc, st, 262144, 64, step + live - 1) == (
        "rerecord")
    assert adj.record_plan(sc, st, 262144, 64, one + live) == "rerecord"
    with pytest.raises(NotImplementedError) as e:
        adj.record_plan(sc, st, 262144, 64, one + live - 1)
    assert str(one) in str(e.value) and "ray_chunk_size" in str(e.value)
    assert str(one + live - 1) in str(e.value)
    assert (mk.LAUNCHES, adj.LAUNCHES, adj.SWEEP_LAUNCHES) == before


def test_emitter_gets_its_emission_only_through_the_light_term():
    """glow_orbs' emitters are spheres that few rays shade. On the rays
    whose paths shade no emitter (the others get a zero cotangent), an
    emitter's d emission comes from the light term alone, under the sweep's
    third key (the drawn light's material): it is not zero, and the record
    route's plain halves give it as jax.grad does (ATOL, RTOL) and as the
    port's lockstep autograd does."""
    name, js, scene, kw, rays = _make_case("B2+l_orbs")
    st = RenderSettings(**kw)
    o, d, far, sidx, seed = _port_rays(rays)
    rec = adj.record_transcript_reference(scene, o, d, far, sidx, seed, st)
    em = scene.materials.emissive
    emitters = torch.nonzero(em[:, 3] * em[:, :3].amax(dim=1) > 0).flatten()
    n_shaded = rec.end.to(torch.int64) & 0xFFFF
    slot = torch.arange(rec.word.shape[0])[:, None]
    mat = rec.word.to(torch.int64) & 0xFF
    shades = ((slot < n_shaded[None]) & torch.isin(mat, emitters)).any(dim=0)
    assert 0 < int(shades.sum()) < 0.1 * shades.shape[0]
    keep = (~shades).numpy()
    rays = dict(rays, ct=rays["ct"] * keep[:, None])
    ct = torch.from_numpy(rays["ct"])
    lit_by = (rec.word.to(torch.int64) >> 21) & 0x3F
    assert bool(torch.isin(lit_by[_lit(rec) & torch.from_numpy(keep)[None]],
                           emitters).all())
    d_out = torch.cat([ct, torch.zeros((ct.shape[0], 4))], dim=1)
    dmat, _ = adj.sweep_reference(scene, st, rec, d_out)
    ref, _ = adj.trace_grad_outputs_reference(scene, o, d, far, sidx, seed,
                                              d_out, st)
    _assert_columns(dmat, ref)
    assert bool((dmat[emitters, 0:3].abs().amax(dim=1) > 0).all())
    got = interop.material_table_to_numpy(
        adj.material_cotangents(scene, dmat))
    want = _jax_material_grads(js, kw, rays)
    e = emitters.numpy()
    assert np.abs(want["emissive"][e]).min() > 0
    np.testing.assert_allclose(got["emissive"][e], want["emissive"][e],
                               atol=ATOL, rtol=RTOL)
