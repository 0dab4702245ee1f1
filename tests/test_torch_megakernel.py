"""The port's megakernel module and lockstep integrator vs the JAX
package's lockstep tracer, on the cases of the JAX package's own
fused-vs-lockstep tests (`tests/test_megakernel.py:46-75`). The CUDA
kernel itself is held to its plain version in
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
import torch

import halogen_tpu as jht
from halogen_tpu.config import SamplerKind as JSamplerKind
from halogen_tpu.integrator.camera import generate_rays as j_generate_rays
from halogen_tpu.integrator.trace import trace_rays as j_trace_rays
from halogen_tpu.sampler import sobol as jsob
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu_torch import interop
from halogen_tpu_torch.config import RenderSettings, SamplerKind
from halogen_tpu_torch.integrator.trace import trace_rays
from halogen_tpu_torch.kernels import megakernel as mk

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


def _inputs(kw):
    """Cornell glossy rays of one spp lane, as the JAX tests make them;
    returns the JAX scene and the rays as numpy."""
    st = _jax_settings(kw)
    w = st.width
    n = w * w
    cam = jht.make_camera(**CAM)
    pix = jnp.arange(n, dtype=jnp.int32)
    seed = jsob.pixel_seed(pix.astype(jnp.uint32))
    sidx = jsob.sample_index(jnp.uint32(0), jnp.uint32(0),
                             st.samples_per_pixel)
    o, d = j_generate_rays(cam, pix % w, pix // w, w, w, st.filter_radius,
                           sidx, seed, jsob.ld_sample_2d)
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

    scene = interop.scene_from_numpy(interop.scene_to_numpy(jscene))
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


def test_deferred_miss_record():
    """The plain version's extra outputs: the attenuation a ray carried
    when it left the box through its open front (zero for rays that never
    missed), a nonnegative roughness accumulator and unit final
    directions."""
    kw = CASES["sobol_no_rr"]
    jscene, _, inp = _inputs(kw)
    scene = interop.scene_from_numpy(interop.scene_to_numpy(jscene))
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
    glass = interop.scene_from_numpy(interop.scene_to_numpy(
        jcornell.glass_sphere_box().build()))
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        trace_rays(glass, o, d, torch.full((4,), 10.0), 0, 1,
                   RenderSettings())
    cornell = interop.scene_from_numpy(interop.scene_to_numpy(
        jcornell.cornell_box().build()))
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        mk.trace_color_fused(cornell, o, d, torch.tensor(10.0), 0, 1,
                             RenderSettings(use_envmap=True))
