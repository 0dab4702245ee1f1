"""The port's megakernel module and lockstep integrator vs the JAX
package's lockstep tracer, on the cases of the JAX package's own
fused-vs-lockstep tests (`tests/test_megakernel.py:46-75`, and its glass
and envmap fixtures, `:164-192`), and on a small env-NEE fixture. The
CUDA kernel itself is held to its plain version in
`tests/test_torch_kernel_cuda.py`.

Tolerance: per ray atol = rtol = 1e-5, as the JAX package holds its own
fused kernel to its lockstep tracer. At most 1 ray in 256 may fall
outside: torch and XLA evaluate sin, cos, exp and log with their own
approximations, which can differ by an ulp; on a rare path that ulp flips
a Russian-roulette or edge decision and the whole path changes. The count
of such rays is asserted, not skipped.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)
import torch

import halogen_tpu as jht
from halogen_tpu.config import SamplerKind as JSamplerKind
from halogen_tpu.integrator.camera import generate_rays as j_generate_rays
from halogen_tpu.integrator.trace import trace_rays as j_trace_rays
from halogen_tpu.sampler import sobol as jsob
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene import meshes as jmeshes
from halogen_tpu.scene.envmap import Envmap as JEnvmap
from halogen_tpu_torch import interop
from halogen_tpu_torch.config import (
    DebugMode,
    Intersector,
    RenderSettings,
    SamplerKind,
)
from halogen_tpu_torch.integrator.trace import trace_rays
from halogen_tpu_torch.kernels import megakernel as mk

CPU = "cpu"  # the port builds on the card unless asked for the CPU

CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
ATOL = RTOL = 1e-5

CASES = {
    "sobol_rr": dict(width=16, height=16, max_bounces=4,
                     sampler=SamplerKind.SOBOL, russian_roulette=True),
    "sobol_no_rr": dict(width=16, height=16, max_bounces=4,
                        sampler=SamplerKind.SOBOL, russian_roulette=False),
    "prng_rr": dict(width=16, height=16, max_bounces=4,
                    sampler=SamplerKind.PRNG, russian_roulette=True),
    "bounce_limits": dict(width=12, height=12, max_bounces=6,
                          max_diffuse_bounces=1, max_glossy_bounces=2,
                          russian_roulette=False),
}

_j_trace = jax.jit(j_trace_rays, static_argnames=("settings",))


def _jax_settings(kw):
    kw = dict(kw)
    if "sampler" in kw:
        kw["sampler"] = JSamplerKind(int(kw["sampler"]))
    return jht.RenderSettings(**kw)


def _inputs(kw, scene=None, cam_kw=CAM):
    """Rays of one spp lane, as the JAX tests make them (Cornell glossy
    unless `scene` is given); returns the JAX scene and the rays as
    numpy."""
    st = _jax_settings(kw)
    w = st.width
    n = w * w
    cam = jht.make_camera(**cam_kw)
    pix = jnp.arange(n, dtype=jnp.int32)
    seed = jsob.pixel_seed(pix.astype(jnp.uint32))
    sidx = jsob.sample_index(jnp.uint32(0), jnp.uint32(0),
                             st.samples_per_pixel)
    o, d = j_generate_rays(cam, pix % w, pix // w, w, w, st.filter_radius,
                           sidx, seed, jsob.ld_sample_2d)
    if scene is None:
        scene = jcornell.cornell_box(glossy=True).build()
    return scene, cam, dict(
        o=np.array(o), d=np.array(d),
        sidx=np.full((n,), np.asarray(sidx), np.uint32),
        seed=np.asarray(seed), far=np.float32(np.asarray(cam.far)))


def _outside(ref, got):
    """Rays with any channel outside atol + rtol * |ref|."""
    bad = np.abs(got - ref) > ATOL + RTOL * np.abs(ref)
    return bad.reshape(bad.shape[0], -1).any(axis=1)


def _port_args(inp):
    return (torch.from_numpy(inp["o"]), torch.from_numpy(inp["d"]),
            torch.from_numpy(inp["sidx"].astype(np.int64)),
            torch.from_numpy(inp["seed"].astype(np.int64)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_lockstep_and_fused_plain_match_jax(case):
    kw = CASES[case]
    jscene, _, inp = _inputs(kw)
    n = inp["o"].shape[0]
    ref = np.asarray(_j_trace(
        jscene, jnp.asarray(inp["o"]), jnp.asarray(inp["d"]),
        jnp.full((n,), inp["far"]), jnp.asarray(inp["sidx"]),
        jnp.asarray(inp["seed"]), _jax_settings(kw)).color)

    scene = interop.scene_from_numpy(interop.scene_to_numpy(jscene), device=CPU)
    st = RenderSettings(**kw)
    assert mk.fused_supported(scene, st)
    o, d, sidx, seed = _port_args(inp)
    far = torch.full((n,), float(inp["far"]))

    lock = trace_rays(scene, o, d, far, sidx, seed, st)
    fused = mk.trace_fused_outputs(scene, o, d, torch.tensor(inp["far"]),
                                   sidx, seed, st)
    assert fused.shape == (n, mk.N_OUTPUTS)
    color = mk.trace_color_fused(scene, o, d, torch.tensor(inp["far"]),
                                 sidx, seed, st)
    # the kernel module's plain version is the lockstep integrator
    torch.testing.assert_close(fused[:, :3], lock.color, rtol=0, atol=0)
    torch.testing.assert_close(color, lock.color, rtol=0, atol=0)
    torch.testing.assert_close(fused[:, 7:], lock.direction, rtol=0, atol=0)

    got = lock.color.numpy()
    assert np.isfinite(got).all() and got.max() > 0.0
    outside = _outside(ref, got)
    assert outside.sum() <= n // 256, (
        f"{outside.sum()} of {n} rays outside 1e-5; max abs diff "
        f"{np.abs(got - ref).max()}")


SKY_CAM = dict(position=(0, 1, 6), target=(0, 0.5, 0), fov_deg=40)

# The JAX package's glass and envmap fixtures (tests/test_megakernel.py
# :164-192), the glass golden's depth, and a small env-NEE scene (the
# envmap_nee golden's at 12x12): name -> (scene, camera, settings).
SLICE = {
    "glass": (lambda: jcornell.glass_sphere_box().build(), CAM,
              dict(width=8, height=8, max_bounces=4)),
    "glass_deep": (lambda: jcornell.glass_sphere_box().build(), CAM,
                   dict(width=16, height=16, max_bounces=8,
                        max_transmission_bounces=8)),
    "envmap": (lambda: jcornell.cornell_box(glossy=True).build(
        envmap=JEnvmap.gradient_sky()), CAM,
        dict(width=8, height=8, max_bounces=3, use_envmap=True,
             env_mip_level=1)),
    "env_nee": (lambda: jcornell.material_demo_spheres().build(
        envmap=JEnvmap.gradient_sky()), SKY_CAM,
        dict(width=12, height=12, max_bounces=4, use_envmap=True,
             env_importance_sampling=True, env_mip_level=0)),
    # the stack and env NEE together (the kernel's fourth variant)
    "glass_env_nee": (lambda: jcornell.glass_sphere_box().build(
        envmap=JEnvmap.gradient_sky()), CAM,
        dict(width=8, height=8, max_bounces=6, max_transmission_bounces=6,
             use_envmap=True, env_importance_sampling=True,
             env_mip_level=0)),
}


def _slice_case(name):
    make, cam_kw, kw = SLICE[name]
    jscene, _, inp = _inputs(kw, make(), cam_kw)
    scene = interop.scene_from_numpy(interop.scene_to_numpy(jscene), device=CPU)
    return jscene, scene, kw, inp


@pytest.mark.parametrize("name", sorted(SLICE))
def test_slice_lockstep_matches_jax(name):
    """Glass (the medium stack), the deferred sky with its mip bias, and
    env NEE with MIS: the port's lockstep against the JAX lockstep at the
    tolerance above; the kernel module's plain route (outputs, then the
    sky pass) gives the lockstep color bit for bit."""
    jscene, scene, kw, inp = _slice_case(name)
    n = inp["o"].shape[0]
    ref = np.asarray(_j_trace(
        jscene, jnp.asarray(inp["o"]), jnp.asarray(inp["d"]),
        jnp.full((n,), inp["far"]), jnp.asarray(inp["sidx"]),
        jnp.asarray(inp["seed"]), _jax_settings(kw)).color)
    st = RenderSettings(**kw)
    assert mk.fused_supported(scene, st)
    o, d, sidx, seed = _port_args(inp)
    lock = trace_rays(scene, o, d, torch.full((n,), float(inp["far"])), sidx,
                      seed, st)
    far = torch.tensor(inp["far"])
    outputs = mk.trace_fused_outputs(scene, o, d, far, sidx, seed, st)
    nee = st.env_importance_sampling
    assert outputs.shape == (n, mk.N_OUTPUTS_NEE if nee else mk.N_OUTPUTS)
    color = mk.trace_color_fused(scene, o, d, far, sidx, seed, st)
    torch.testing.assert_close(color, lock.color, rtol=0, atol=0)

    got = lock.color.numpy()
    assert np.isfinite(got).all() and got.max() > 0.0
    outside = _outside(ref, got)
    assert outside.sum() <= max(1, n // 256), (
        f"{outside.sum()} of {n} rays outside 1e-5; max abs diff "
        f"{np.abs(got - ref).max()}")
    if st.use_envmap:  # some rays see the sky
        assert (outputs[:, 3:6] > 0).any()
    if nee:  # some sky hits are MIS-weighted against NEE
        assert (outputs[:, 11] > 0.5).any()


# Big scenes (tests/test_megakernel.py:195-257): the glass dragon, and a
# 1,280-triangle dragon under the sky with and without env NEE, at 12x12.
DRAGON_CAM = dict(position=(0, 1.5, 5.0), target=(0, -0.3, 0), fov_deg=45)
BIG = {
    "glass_dragon": (lambda: jmeshes.glass_dragon_scene().build(
        world_bvh=False), dict(width=12, height=12, max_bounces=3)),
    "dragon_sky": (lambda: jmeshes.dragons_hero_scene(1, tris=1280).build(
        envmap=JEnvmap.gradient_sky(), world_bvh=False),
        dict(width=12, height=12, max_bounces=3, use_envmap=True)),
    "dragon_sky_nee": (lambda: jmeshes.dragons_hero_scene(
        1, tris=1280).build(envmap=JEnvmap.gradient_sky(), world_bvh=False),
        dict(width=12, height=12, max_bounces=3, use_envmap=True,
             env_importance_sampling=True)),
}


@pytest.mark.parametrize("name", sorted(BIG))
def test_big_scene_lockstep_matches_jax(name):
    """Scenes over the brute tier's cap: the port's lockstep (on the CPU
    AUTO walks each mesh's BVH, as the JAX lockstep does) against the JAX
    lockstep at the tolerance above; the kernel module's plain route
    (brute-force hits) and the world-BVH route give the same colors."""
    make, kw = BIG[name]
    jscene, _, inp = _inputs(kw, make(), DRAGON_CAM)
    scene = interop.scene_from_numpy(interop.scene_to_numpy(jscene),
                                     device=CPU)
    n = inp["o"].shape[0]
    ref = np.asarray(_j_trace(
        jscene, jnp.asarray(inp["o"]), jnp.asarray(inp["d"]),
        jnp.full((n,), inp["far"]), jnp.asarray(inp["sidx"]),
        jnp.asarray(inp["seed"]), _jax_settings(kw)).color)
    st = RenderSettings(**kw)
    assert mk.uses_bvh(scene) and mk.fused_supported(scene, st)
    o, d, sidx, seed = _port_args(inp)
    far = torch.full((n,), float(inp["far"]))
    lock = trace_rays(scene, o, d, far, sidx, seed, st).color.numpy()
    assert np.isfinite(lock).all() and lock.max() > 0.0
    outside = _outside(ref, lock)
    assert outside.sum() <= max(1, n // 256), (
        f"{outside.sum()} of {n} rays outside 1e-5; max abs diff "
        f"{np.abs(lock - ref).max()}")
    plain = mk.trace_color_fused(scene, o, d, torch.tensor(inp["far"]),
                                 sidx, seed, st).numpy()
    world = trace_rays(scene, o, d, far, sidx, seed, st.replace(
        intersector=Intersector.RAYLET)).color.numpy()
    for got in (plain, world):
        assert _outside(lock, got).sum() <= max(1, n // 256)


def test_glass_transmission_limit():
    """On the glass box transmissive bounces are counted: a transmission
    limit of 0 changes the image."""
    _, scene, kw, inp = _slice_case("glass_deep")
    o, d, sidx, seed = _port_args(inp)
    n = inp["o"].shape[0]
    st = RenderSettings(**kw)
    full = trace_rays(scene, o, d, torch.full((n,), float(inp["far"])), sidx,
                      seed, st).color
    cut = trace_rays(scene, o, d, torch.full((n,), float(inp["far"])), sidx,
                     seed, st.replace(max_transmission_bounces=0)).color
    assert not torch.equal(full, cut)


def test_deferred_miss_record():
    """The plain version's extra outputs: the attenuation a ray carried
    when it left the box through its open front (zero for rays that never
    missed), a nonnegative roughness accumulator and unit final
    directions."""
    kw = CASES["sobol_no_rr"]
    jscene, _, inp = _inputs(kw)
    scene = interop.scene_from_numpy(interop.scene_to_numpy(jscene), device=CPU)
    o, d, sidx, seed = _port_args(inp)
    out = mk.trace_fused_outputs(scene, o, d, torch.tensor(inp["far"]),
                                 sidx, seed, RenderSettings(**kw))
    matten, rough = out[:, 3:6], out[:, 6]
    assert torch.all(matten >= 0) and torch.all(matten <= 1.0 + 1e-6)
    assert torch.all(rough >= 0)
    # bounced rays escape through the open front; the rest never miss
    escaped = torch.any(matten > 0, dim=1)
    assert 0 < int(escaped.sum()) < out.shape[0]
    np.testing.assert_allclose(torch.linalg.norm(out[:, 7:], dim=1).numpy(),
                               1.0, atol=1e-5)


def test_out_of_slice_raises():
    """Debug views render through the lockstep (they raised before); the
    megakernel still refuses them, naming the lockstep. Glass, envmaps,
    env NEE and area-light NEE are the kernel's."""
    glass = interop.scene_from_numpy(interop.scene_to_numpy(
        jcornell.glass_sphere_box().build()), device=CPU)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    st = RenderSettings(debug_mode=DebugMode.ALBEDO)
    assert not mk.fused_supported(glass, st)
    out = trace_rays(glass, o, d, torch.full((4,), 10.0), 0, 1, st)
    assert torch.isfinite(out.first_hit_t).all()  # the back wall
    assert (out.first_hit_albedo > 0).any(dim=1).all()
    with pytest.raises(NotImplementedError, match="lockstep integrator"):
        mk.trace_color_fused(glass, o, d, torch.tensor(10.0), 0, 1, st)
    st = RenderSettings(light_importance_sampling=True)
    assert mk.fused_supported(glass, st)
    assert torch.isfinite(
        mk.trace_color_fused(glass, o, d, torch.tensor(10.0), 0, 1, st)).all()
    sky = interop.scene_from_numpy(interop.scene_to_numpy(
        jcornell.cornell_box().build(envmap=JEnvmap.gradient_sky())), device=CPU)
    st = RenderSettings(use_envmap=True, env_importance_sampling=True)
    assert mk.fused_supported(sky, st) and mk.fused_supported(glass, st)
    col = mk.trace_color_fused(sky, o, d, torch.tensor(10.0), 0, 1, st)
    assert torch.isfinite(col).all()


@pytest.mark.slow
@pytest.mark.parametrize("name", ["glass", "env_nee"])
def test_plain_matches_jax_interpret_kernel(name):
    """The port's plain route against the JAX package's own Pallas
    megakernel in interpret mode (glass with `stack_depth=4`, exact here:
    nesting never exceeds 3, as `tests/test_megakernel.py:175` uses it),
    at the bound the JAX package holds that kernel to."""
    from halogen_tpu.kernels.megakernel import trace_color_fused as j_fused

    jscene, scene, kw, inp = _slice_case(name)
    ref = np.asarray(j_fused(
        jscene, jnp.asarray(inp["o"]), jnp.asarray(inp["d"]),
        jnp.asarray(inp["far"]), jnp.asarray(inp["sidx"]),
        jnp.asarray(inp["seed"]), _jax_settings(kw), interpret=True,
        stack_depth=4))
    o, d, sidx, seed = _port_args(inp)
    got = mk.trace_color_fused(scene, o, d, torch.tensor(inp["far"]), sidx,
                               seed, RenderSettings(**kw)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
