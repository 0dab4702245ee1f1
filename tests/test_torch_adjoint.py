"""The port's adjoint module (`kernels/adjoint.py`) and the differentiable
fused tracer (`megakernel.trace_color_fused_diff`) vs the JAX package.

The plain version of the adjoint kernel is autograd through the port's
lockstep integrator; through `material_cotangents` it must equal
`jax.grad` through the JAX lockstep tracer on the rays of
`tests/test_megakernel.py:33-43` (8x8, Cornell glossy, and the
glass-in-glass box of its glass case, `:79-118`), with Russian roulette on
and off, at atol = rtol = 1e-6: the two integrators are bit-identical on
these rays and their backward passes differ only in the order of a few
float sums. The CUDA kernel is held to this plain version in
`tests/test_torch_adjoint_cuda.py`.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)
import torch

import halogen_tpu as jht
from halogen_tpu.integrator.camera import generate_rays as j_generate_rays
from halogen_tpu.integrator.trace import trace_rays as j_trace_rays
from halogen_tpu.sampler import sobol as jsob
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene.envmap import Envmap as JEnvmap
from halogen_tpu_torch import interop
from halogen_tpu_torch.config import RenderSettings
from halogen_tpu_torch.diff.grad import FLOAT_MATERIAL_FIELDS
from halogen_tpu_torch.integrator.trace import trace_rays
from halogen_tpu_torch.kernels import adjoint as adj
from halogen_tpu_torch.kernels import megakernel as mk

CPU = "cpu"  # the port builds on the card unless asked for the CPU

CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
W = 8
TOL = 1e-6


def _settings(rr):
    return dict(width=W, height=W, max_bounces=3, russian_roulette=rr)


def _fixture(jscene):
    """JAX scene, its port, and the 8x8 rays of test_megakernel._rays as
    numpy, with a cotangent drawn from a numpy seed."""
    cam = jht.make_camera(**CAM)
    n = W * W
    pix = jnp.arange(n, dtype=jnp.int32)
    seed = jsob.pixel_seed(pix.astype(jnp.uint32))
    sidx = jsob.sample_index(jnp.uint32(0), jnp.uint32(0), 1)
    o, d = j_generate_rays(cam, pix % W, pix // W, W, W, 1.0, sidx, seed,
                           jsob.ld_sample_2d)
    rays = dict(o=np.array(o), d=np.array(d),
                sidx=np.full((n,), np.asarray(sidx), np.uint32),
                seed=np.asarray(seed), far=np.float32(np.asarray(cam.far)),
                ct=np.random.default_rng(0).normal(size=(n, 3)).astype(
                    np.float32))
    scene = interop.scene_from_numpy(interop.scene_to_numpy(jscene), device=CPU)
    return jscene, scene, rays


@pytest.fixture(scope="module")
def fixture():
    return _fixture(jcornell.cornell_box(glossy=True).build())


@pytest.fixture(scope="module")
def glass():
    return _fixture(jcornell.glass_sphere_box().build())


def _port_rays(rays, requires_grad=False):
    o = torch.from_numpy(rays["o"]).requires_grad_(requires_grad)
    d = torch.from_numpy(rays["d"]).requires_grad_(requires_grad)
    return (o, d, torch.tensor(rays["far"]),
            torch.from_numpy(rays["sidx"].astype(np.int64)),
            torch.from_numpy(rays["seed"].astype(np.int64)),
            torch.from_numpy(rays["ct"]))


def _jax_grads(jscene, rays, rr, env=False, **kw):
    """jax.grad of sum(color * ct) through the JAX lockstep tracer w.r.t.
    the material table (and, with `env`, the envmap's mips)."""
    n = rays["o"].shape[0]
    st = jht.RenderSettings(**_settings(rr), **kw)

    def loss(mats, mips):
        col = j_trace_rays(dataclasses.replace(jscene, materials=mats,
                                               env_mips=mips),
                           jnp.asarray(rays["o"]), jnp.asarray(rays["d"]),
                           jnp.full((n,), rays["far"]),
                           jnp.asarray(rays["sidx"]),
                           jnp.asarray(rays["seed"]), st).color
        return jnp.sum(col * jnp.asarray(rays["ct"]))

    g, g_env = jax.jit(jax.grad(loss, argnums=(0, 1), allow_int=True))(
        jscene.materials, jscene.env_mips)
    g = interop.material_table_to_numpy(g)
    return (g, [np.asarray(m) for m in g_env]) if env else g


def _assert_fields_close(got: dict, ref: dict, atol=TOL, rtol=TOL):
    for f in FLOAT_MATERIAL_FIELDS:
        np.testing.assert_allclose(got[f], ref[f], atol=atol, rtol=rtol,
                                   err_msg=f)


@pytest.mark.parametrize("rr", [True, False])
def test_plain_adjoint_matches_jax_grad(fixture, rr):
    jscene, scene, rays = fixture
    st = RenderSettings(**_settings(rr))
    assert adj.adjoint_covers(scene, st)
    o, d, far, sidx, seed, ct = _port_rays(rays)
    dmat = adj.trace_grad_fused_materials(scene, o, d, far, sidx, seed, ct,
                                          st)
    assert dmat.shape == (scene.materials.count, adj.N_GRAD)
    assert adj.LAUNCHES == 0  # CPU tensors take the plain version
    cot = adj.material_cotangents(scene, dmat)
    assert cot.priority.dtype == torch.int32
    assert not cot.priority.any()
    got = interop.material_table_to_numpy(cot)
    ref = _jax_grads(jscene, rays, rr)
    assert np.abs(ref["albedo"]).max() > 0 and np.abs(ref["emissive"]).max() > 0
    _assert_fields_close(got, ref)
    for f in ("metallic", "roughness", "ior"):
        assert not got[f].any(), f


@pytest.mark.parametrize("rr", [True, False])
def test_plain_adjoint_matches_jax_grad_on_glass(glass, rr):
    """The nested-dielectric case: the stack's absorption slots carry d
    absorption to the medium's material, as JAX's lockstep does."""
    jscene, scene, rays = glass
    st = RenderSettings(**_settings(rr))
    assert scene.any_transmissive and adj.adjoint_covers(scene, st)
    o, d, far, sidx, seed, ct = _port_rays(rays)
    got = interop.material_table_to_numpy(adj.material_cotangents(
        scene, adj.trace_grad_fused_materials(scene, o, d, far, sidx, seed,
                                              ct, st)))
    ref = _jax_grads(jscene, rays, rr)
    assert np.abs(ref["absorption"]).max() > 0
    _assert_fields_close(got, ref)
    for f in ("metallic", "roughness", "ior"):
        assert not got[f].any(), f


def _loss_through(fn, scene, rays, st):
    """Material leaves, and the loss (color * ct).sum() of `fn`."""
    mats = scene.materials
    leaves = {f: getattr(mats, f).clone().requires_grad_(True)
              for f in FLOAT_MATERIAL_FIELDS}
    sc = dataclasses.replace(scene,
                             materials=dataclasses.replace(mats, **leaves))
    o, d, far, sidx, seed, ct = _port_rays(rays)
    return leaves, (fn(sc, o, d, far, sidx, seed, st) * ct).sum()


@pytest.mark.parametrize("rr", [True, False])
@pytest.mark.parametrize("case", ["cornell", "glass"])
def test_fused_diff_matches_lockstep_autograd(fixture, glass, case, rr):
    """trace_color_fused_diff on CPU tensors (plain forward, plain adjoint
    backward) gives the gradients of autograd through trace_rays."""
    _, scene, rays = fixture if case == "cornell" else glass
    st = RenderSettings(**_settings(rr))
    n = rays["o"].shape[0]
    fused = lambda sc, o, d, far, sidx, seed, st: mk.trace_color_fused_diff(
        sc, o, d, far, sidx, seed, st)
    lock = lambda sc, o, d, far, sidx, seed, st: trace_rays(
        sc, o, d, far.expand(n), sidx, seed, st).color
    leaves_f, loss_f = _loss_through(fused, scene, rays, st)
    leaves_l, loss_l = _loss_through(lock, scene, rays, st)
    assert loss_f.grad_fn is not None
    torch.testing.assert_close(loss_f, loss_l, rtol=0, atol=0)
    loss_f.backward()
    loss_l.backward()
    for f in FLOAT_MATERIAL_FIELDS:
        torch.testing.assert_close(leaves_f[f].grad, leaves_l[f].grad,
                                   atol=TOL, rtol=TOL, msg=f)


@pytest.mark.parametrize("case", ["cornell", "glass"])
def test_pixel_launch_wrappers_take_plain_version_on_cpu(fixture, glass,
                                                         case):
    """The launch-from-pixels wrappers on CPU pixels: `trace_pixels_outputs`
    gives the plain version's outputs on `group_rays`' rays, and
    `trace_color_pixels_diff` the color and the material gradients of
    `trace_color_fused_diff` on those rays, bit for bit; no kernel is
    launched."""
    from halogen_tpu_torch.integrator.trace import group_rays

    _, scene, _ = fixture if case == "cornell" else glass
    st = RenderSettings(**_settings(True), samples_per_pixel=8)
    cam = interop.camera_from_numpy(
        interop.camera_to_numpy(jht.make_camera(**CAM)), device=CPU)
    pix = torch.from_numpy(np.random.default_rng(1).permutation(W * W)[:24])
    frame, lane0, spp_block = 2, 4, 2
    view = mk.pixel_view(cam, st, frame, pix)
    assert view.block is None and view.frame_word is None
    before = mk.LAUNCHES
    out, o, d, sidx, seed = mk.trace_pixels_outputs(
        scene, view, lane0, spp_block, st, write_rays=True)
    for got, ref in zip((o, d, sidx, seed),
                        group_rays(cam, st, frame, pix, lane0, spp_block)):
        assert torch.equal(got, ref)
    assert out.shape == (48, mk.N_OUTPUTS)
    assert torch.equal(out, mk.trace_fused_outputs(scene, o, d, cam.far,
                                                   sidx, seed, st))
    assert torch.equal(out, mk.trace_pixels_outputs(scene, view, lane0,
                                                    spp_block, st))

    ct = torch.from_numpy(np.random.default_rng(2).normal(
        size=(48, 3)).astype(np.float32))
    grads = []
    for fn in (lambda sc: mk.trace_color_pixels_diff(sc, view, lane0,
                                                     spp_block, st),
               lambda sc: mk.trace_color_fused_diff(sc, o, d, cam.far, sidx,
                                                    seed, st)):
        albedo = scene.materials.albedo.clone().requires_grad_(True)
        sc = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, albedo=albedo))
        col = fn(sc)
        (col * ct).sum().backward()
        grads.append((col.detach(), albedo.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    assert grads[0][1].abs().max() > 0
    assert mk.LAUNCHES == before
    with pytest.raises(ValueError, match="int64"):
        mk.pixel_view(cam, st, frame, pix.to(torch.int32))


def test_fused_diff_gives_geometry_and_rays_no_gradient(fixture):
    """The Function's backward returns a cotangent for the material table
    only: geometry, camera rays and far get none (as the JAX fused
    adjoint route, `megakernel.py:1925-1951`)."""
    _, scene, rays = fixture
    st = RenderSettings(**_settings(True))
    verts = scene.tri_verts_world.clone().requires_grad_(True)
    centers = scene.sphere_center.clone().requires_grad_(True)
    albedo = scene.materials.albedo.clone().requires_grad_(True)
    sc = dataclasses.replace(
        scene, tri_verts_world=verts, sphere_center=centers,
        materials=dataclasses.replace(scene.materials, albedo=albedo))
    o, d, far, sidx, seed, ct = _port_rays(rays, requires_grad=True)
    far = far.clone().requires_grad_(True)
    tables = mk._scene_tables(sc)
    tri_tab, _, sph_tab, mat_tab = tables
    assert tri_tab.requires_grad and sph_tab.requires_grad
    assert mat_tab.requires_grad
    col = mk.trace_color_fused_diff(sc, o, d, far, sidx, seed, st, tables)
    (col * ct).sum().backward()
    assert albedo.grad is not None and albedo.grad.abs().max() > 0
    for name, t in (("verts", verts), ("centers", centers), ("origin", o),
                    ("direction", d), ("far", far)):
        assert t.grad is None, name


def test_adjoint_out_of_slice_raises(fixture):
    """Envmap scenes have the fused adjoint, with and without env NEE: on
    the rays of the fixture under the gradient sky its plain version gives
    the JAX lockstep's gradient for every material field (roughness too,
    through the mip-bias level of the sky lookup) and every mip, and the
    differentiable fused tracer's backward runs through it. So does
    area-light NEE (B2+l) under the sky with env NEE: its plain version
    gives the JAX lockstep's material gradient on the rays whose colors
    the two packages agree on, at the light-NEE gradient's rtol 1e-5."""
    _, _, rays = fixture
    jsky = jcornell.cornell_box(glossy=True).build(
        envmap=JEnvmap.gradient_sky())
    sky = interop.scene_from_numpy(interop.scene_to_numpy(jsky), device=CPU)
    glass = interop.scene_from_numpy(interop.scene_to_numpy(
        jcornell.glass_sphere_box().build()), device=CPU)
    o, d, far, sidx, seed, _ = _port_rays(rays)
    n = o.shape[0]
    st = RenderSettings(**_settings(True))
    assert adj.adjoint_covers(glass, st)
    assert adj.adjoint_covers(sky, st)
    for env in (dict(use_envmap=True),
                dict(use_envmap=True, env_importance_sampling=True,
                     env_mip_level=0)):
        st_env = st.replace(**env)
        assert adj.adjoint_covers(sky, st_env)
        # the rays whose colors the two packages agree on: with env NEE
        # one of these 64 rays takes a near-mirror glossy pdf, which turns
        # an ulp of direction into 1e-2 of its color
        col = trace_rays(sky, o, d, far.expand(n), sidx, seed, st_env).color
        jcol = j_trace_rays(
            jsky, jnp.asarray(rays["o"]), jnp.asarray(rays["d"]),
            jnp.full((n,), rays["far"]), jnp.asarray(rays["sidx"]),
            jnp.asarray(rays["seed"]),
            jht.RenderSettings(**_settings(True), **env)).color
        agree = np.abs(col.numpy() - np.asarray(jcol)).max(axis=1) <= 1e-5
        assert agree.sum() >= n - 2
        masked = dict(rays, ct=rays["ct"] * agree[:, None])
        ct = torch.from_numpy(masked["ct"])
        dmat, d_env = adj.trace_grad_fused(sky, o, d, far, sidx, seed, ct,
                                           st_env)
        assert dmat.shape == (sky.materials.count, adj.N_GRAD_SKY)
        got = interop.material_table_to_numpy(
            adj.material_cotangents(sky, dmat))
        ref, ref_env = _jax_grads(jsky, masked, True, env=True, **env)
        assert np.abs(ref["roughness"]).max() > 0
        _assert_fields_close(got, ref)
        assert len(d_env) == len(ref_env)
        # a texel's cotangent sums the taps of many rays, of both signs
        # (ct is normal), which XLA's scatter and torch's index_add add in
        # other orders: 1e-4 of the level's largest, as on the card
        for level, (g, r) in enumerate(zip(d_env, ref_env)):
            np.testing.assert_allclose(
                g.numpy(), r, atol=1e-4 * np.abs(r).max() + TOL, rtol=1e-5,
                err_msg=f"mip {level}")
        # the fused tracer's backward runs the same adjoint
        mats = dataclasses.replace(
            sky.materials,
            albedo=sky.materials.albedo.clone().requires_grad_(True))
        col = mk.trace_color_fused_diff(
            dataclasses.replace(sky, materials=mats), o, d, far, sidx, seed,
            st_env)
        (col * ct).sum().backward()
        np.testing.assert_allclose(mats.albedo.grad.numpy()[:, :3],
                                   ref["albedo"][:, :3], atol=TOL, rtol=1e-5)
    light = dict(use_envmap=True, env_importance_sampling=True,
                 env_mip_level=0, light_importance_sampling=True)
    st_l = st.replace(**light)
    assert adj.adjoint_covers(sky, st_l) and sky.lights is not None
    col = trace_rays(sky, o, d, far.expand(n), sidx, seed, st_l).color
    jcol = j_trace_rays(
        jsky, jnp.asarray(rays["o"]), jnp.asarray(rays["d"]),
        jnp.full((n,), rays["far"]), jnp.asarray(rays["sidx"]),
        jnp.asarray(rays["seed"]),
        jht.RenderSettings(**_settings(True), **light)).color
    agree = np.abs(col.numpy() - np.asarray(jcol)).max(axis=1) <= 1e-5
    assert agree.sum() >= n - 2
    masked = dict(rays, ct=rays["ct"] * agree[:, None])
    dmat = adj.trace_grad_fused_materials(
        sky, o, d, far, sidx, seed, torch.from_numpy(masked["ct"]), st_l)
    got = interop.material_table_to_numpy(adj.material_cotangents(sky, dmat))
    ref = _jax_grads(jsky, masked, True, **light)
    assert np.abs(ref["emissive"]).max() > 0
    # the light-NEE forwards are not bit-identical across the packages
    # (tests/light_nee_cases.py): tests/test_torch_light_nee_grad.py's rtol
    _assert_fields_close(got, ref, rtol=1e-5)


@pytest.mark.parametrize("nee", [False, True], ids=["sky", "env_nee"])
def test_main_path_composition_matches_plain_under_sky(fixture, nee):
    """The composition a render's backward runs under a sky (the fused
    Function, whose backward gives the finest mip the env-NEE records, and
    the sky pass), on CPU tensors where each piece is its plain version,
    gives the plain backward's material columns and every mip's cotangent,
    the finest mip with both its sky taps and its env-NEE texels."""
    _, _, rays = fixture
    sky = interop.scene_from_numpy(interop.scene_to_numpy(
        jcornell.cornell_box(glossy=True).build(
            envmap=JEnvmap.gradient_sky())), device=CPU)
    o, d, far, sidx, seed, ct = _port_rays(rays)
    st = RenderSettings(**_settings(True), use_envmap=True,
                        env_importance_sampling=nee, env_mip_level=0)
    assert adj.env_mode(sky, st) == (2 if nee else 1)
    env_tab = mk.env_table(sky) if nee else None
    dmat, d_env = adj._main_path_grads(sky, o, d, far, sidx, seed, ct, st,
                                       mk._scene_tables(sky), env_tab)
    ref, ref_env = adj.trace_grad_fused_reference(sky, o, d, far, sidx, seed,
                                                  ct, st)
    assert dmat.shape == ref.shape == (sky.materials.count, adj.N_GRAD_SKY)
    assert ref[:, 12].abs().max() > 0
    torch.testing.assert_close(dmat, ref, atol=TOL, rtol=TOL)
    assert len(d_env) == len(ref_env)
    assert ref_env[0].abs().max() > 0
    for level, (g, r) in enumerate(zip(d_env, ref_env)):
        torch.testing.assert_close(g, r, atol=1e-4 * float(r.abs().max())
                                   + TOL, rtol=1e-5, msg=f"mip {level}")
    assert adj.LAUNCHES == 0


@pytest.mark.slow
@pytest.mark.parametrize("rr", [True, False])
def test_plain_adjoint_matches_jax_interpret_kernel(fixture, rr):
    """The port's plain [K, 12] against the JAX package's own Pallas
    adjoint kernel in interpret mode, at the bound the JAX package holds
    that kernel to (`tests/test_megakernel.py:117-118`)."""
    from halogen_tpu.kernels import adjoint as jadj

    jscene, scene, rays = fixture
    n = rays["o"].shape[0]
    ref = np.asarray(jadj.trace_grad_fused_materials(
        jscene, jnp.asarray(rays["o"]), jnp.asarray(rays["d"]),
        jnp.asarray(rays["far"]), jnp.asarray(rays["sidx"]),
        jnp.asarray(rays["seed"]), jnp.asarray(rays["ct"]),
        jht.RenderSettings(**_settings(rr)), interpret=True))
    o, d, far, sidx, seed, ct = _port_rays(rays)
    got = adj.trace_grad_fused_materials(
        scene, o, d, far, sidx, seed, ct,
        RenderSettings(**_settings(rr))).numpy()
    assert got.shape == ref.shape == (scene.materials.count, adj.N_GRAD)
    assert n == W * W
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("case", ["cornell", "glass"])
def test_transcript_route_follows_the_shared_memory_budget(case):
    """The adjoint keeps its transcript in the block's shared memory while
    the block fits SMEM_BUDGET, up to 17 bounces in both boxes, and in a
    device buffer past it; forcing the shared route past the budget
    raises before anything is launched."""
    from halogen_tpu_torch.scene import cornell

    scene = (cornell.glass_sphere_box() if case == "glass"
             else cornell.cornell_box(glossy=True)).build(device=CPU)
    routes = [adj.transcript_route(scene, RenderSettings(max_bounces=b))
              for b in (6, 8, 17, 18, 20)]
    assert routes == ["shared"] * 3 + ["global"] * 2
    assert adj.smem_bytes(scene, RenderSettings(max_bounces=17)) <= \
        adj.SMEM_BUDGET < adj.smem_bytes(scene, RenderSettings(max_bounces=18))
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    rays = (o, d, torch.tensor(1e30), 0, 0, torch.zeros((4, 3)))
    for route, match in (("shared", "does not fit"), ("l2", "unknown")):
        with pytest.raises(ValueError, match=match):
            adj._launch(scene, *rays, RenderSettings(max_bounces=20), None,
                        route=route)
