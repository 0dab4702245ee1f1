"""The port's gradients of envmap scenes vs the JAX package's
(`halogen_tpu/diff/grad.py`), on the CPU.

The port differentiates scenes under a sky, with and without env NEE,
with respect to the material table and every mip of the envmap (on the
card through the sky pair, `kernels/sky.py`, and the adjoint's sky
variants). On the CPU both packages run autograd through their lockstep
integrators; the CUDA kernels are held to the port's plain versions in
`tests/test_torch_adjoint_cuda.py`, `tests/test_torch_sky_cuda.py` and
`chip_smoke.py`. Scenes come from the JAX package through `interop`,
targets from a numpy seed. Material fields and mips must agree at atol
1e-6, rtol 1e-5, as in `tests/test_torch_grad.py`: the two integrators
agree bit for bit on these fixtures and their backward passes differ
only in the order of float sums. The big-scene gradients are in
`tests/test_torch_grad_big.py`, the envmap fit in
`tests/test_torch_env_fit.py`.
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)

import halogen_tpu as jht
from halogen_tpu.diff import grad as jgrad
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene.envmap import Envmap as JEnvmap
import halogen_tpu_torch as tht
from halogen_tpu_torch import interop
from halogen_tpu_torch.diff import grad as tgrad

CPU = "cpu"  # the port builds on the card unless asked for the CPU
CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
ST = dict(width=16, height=16, samples_per_pixel=2, max_bounces=3,
          ray_chunk_size=256)
FIELDS = tgrad.FLOAT_MATERIAL_FIELDS
ATOL, RTOL = 1e-6, 1e-5

_j_loss_grad = jax.jit(jgrad.render_loss_grad.__wrapped__,
                       static_argnames=("settings",))


SKIES = {"gradient": JEnvmap.gradient_sky,
         "constant": lambda: JEnvmap.constant((0.6, 0.7, 0.9))}


def _port(js, cam_kw):
    jc = jht.make_camera(**cam_kw)
    return (jc, interop.scene_from_numpy(interop.scene_to_numpy(js),
                                         device=CPU),
            interop.camera_from_numpy(interop.camera_to_numpy(jc),
                                      device=CPU))


def _target(seed=0):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (ST["height"], ST["width"], 3)).astype(np.float32)


def _grads_both(js, cam_kw, env: bool, **kw):
    """(JAX loss, JAX grads, port loss, port grads), materials and, with
    `env`, the mips as numpy."""
    jc, ts, tc = _port(js, cam_kw)
    target = _target()
    jp = {"materials": js.materials}
    tp = {"materials": ts.materials}
    if env:
        jp["env_mips"], tp["env_mips"] = js.env_mips, ts.env_mips
    jl, jg = _j_loss_grad(jp, js, jc, jht.RenderSettings(**{**ST, **kw}),
                          jnp.asarray(target), 1)
    tl, tg = tgrad.render_loss_grad(tp, ts, tc,
                                    tht.RenderSettings(**{**ST, **kw}),
                                    target, 1)
    out = [float(jl), interop.material_table_to_numpy(jg["materials"]),
           float(tl), interop.material_table_to_numpy(tg["materials"])]
    if env:
        out += [[np.asarray(m) for m in jg["env_mips"]],
                [m.numpy() for m in tg["env_mips"]]]
    return out


def _assert_fields(got, ref):
    for f in FIELDS:
        assert got[f].shape == ref[f].shape
        np.testing.assert_allclose(got[f], ref[f], atol=ATOL, rtol=RTOL,
                                   err_msg=f)


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("sky", sorted(SKIES))
def test_envmap_grads_match_jax(sky, nee):
    """{"materials", "env_mips"} gradients of the Cornell box under a
    gradient and a constant sky, without and with env NEE (mip level 0,
    as the JAX CLI's envmap preset): every material field (roughness
    through the mip-bias level of the lookup) and every mip."""
    js = jcornell.cornell_box().build(envmap=SKIES[sky]())
    kw = dict(use_envmap=True, env_importance_sampling=nee)
    if nee:
        kw["env_mip_level"] = 0
    jl, jg, tl, tg, jenv, tenv = _grads_both(js, CAM, True, **kw)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    _assert_fields(tg, jg)
    assert len(tenv) == len(jenv) == len(js.env_mips)
    assert max(np.abs(m).max() for m in jenv) > 0
    if nee:  # the drawn texels' radiance reaches the finest mip
        assert np.abs(jenv[0]).max() > 0
    for level, (g, r) in enumerate(zip(tenv, jenv)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL,
                                   err_msg=f"mip {level}")


def test_glass_under_the_sky_matches_jax():
    """The glass-in-glass box under the gradient sky with env NEE (the
    stack and NEE together, B2b+c on the card), 6 bounces."""
    js = jcornell.glass_sphere_box().build(envmap=JEnvmap.gradient_sky())
    kw = dict(use_envmap=True, env_importance_sampling=True,
              env_mip_level=0, max_bounces=6, max_transmission_bounces=6)
    jl, jg, tl, tg, jenv, tenv = _grads_both(js, CAM, True, **kw)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert np.abs(jg["absorption"]).max() > 0
    _assert_fields(tg, jg)
    for level, (g, r) in enumerate(zip(tenv, jenv)):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL,
                                   err_msg=f"mip {level}")
