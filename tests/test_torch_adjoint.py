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


def _jax_grads(jscene, rays, rr):
    n = rays["o"].shape[0]
    st = jht.RenderSettings(**_settings(rr))

    def loss(mats):
        col = j_trace_rays(dataclasses.replace(jscene, materials=mats),
                           jnp.asarray(rays["o"]), jnp.asarray(rays["d"]),
                           jnp.full((n,), rays["far"]),
                           jnp.asarray(rays["sidx"]),
                           jnp.asarray(rays["seed"]), st).color
        return jnp.sum(col * jnp.asarray(rays["ct"]))

    g = jax.jit(jax.grad(loss, allow_int=True))(jscene.materials)
    return interop.material_table_to_numpy(g)


def _assert_fields_close(got: dict, ref: dict, atol=TOL, rtol=TOL):
    for f in FLOAT_MATERIAL_FIELDS:
        np.testing.assert_allclose(got[f], ref[f], atol=atol, rtol=rtol,
                                   err_msg=f)


@pytest.mark.parametrize("rr", [True, False])
def test_plain_adjoint_matches_jax_grad(fixture, rr):
    jscene, scene, rays = fixture
    st = RenderSettings(**_settings(rr))
    assert adj.adjoint_supported(scene, st)
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
    assert scene.any_transmissive and adj.adjoint_supported(scene, st)
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
    """Envmap scenes have no fused adjoint yet (ROADMAP A8), with or
    without env NEE; glass scenes do. A scene that carries an envmap it
    does not use is in."""
    _, _, rays = fixture
    sky = interop.scene_from_numpy(interop.scene_to_numpy(
        jcornell.cornell_box(glossy=True).build(
            envmap=JEnvmap.gradient_sky())), device=CPU)
    glass = interop.scene_from_numpy(interop.scene_to_numpy(
        jcornell.glass_sphere_box().build()), device=CPU)
    o, d, far, sidx, seed, ct = _port_rays(rays)
    st = RenderSettings(**_settings(True))
    assert adj.adjoint_supported(glass, st)
    assert adj.adjoint_supported(sky, st)
    for env in (dict(use_envmap=True),
                dict(use_envmap=True, env_importance_sampling=True)):
        st_env = st.replace(**env)
        assert not adj.adjoint_supported(sky, st_env)
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            adj.trace_grad_fused_materials(sky, o, d, far, sidx, seed, ct,
                                           st_env)
        # the forward runs; its backward raises
        mats = dataclasses.replace(
            sky.materials,
            albedo=sky.materials.albedo.clone().requires_grad_(True))
        col = mk.trace_color_fused_diff(
            dataclasses.replace(sky, materials=mats), o, d, far, sidx, seed,
            st_env)
        with pytest.raises(NotImplementedError, match="envmap gradients"):
            (col * ct).sum().backward()


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
