"""`fit_materials(optimize_env=True)` and the envmap's place in the
gradient API (`diff/grad.py`) vs the JAX package's, on the CPU: three
steps' losses, materials and texels at rtol 1e-4 (as
`tests/test_torch_grad.py` holds the material fit), a JAX checkpoint of
an envmap fit resumed in the port, and `render_with_params` with the
mips.
"""

import numpy as np
import jax.numpy as jnp
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)
import torch

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


def _port(js, cam_kw):
    jc = jht.make_camera(**cam_kw)
    return (jc, interop.scene_from_numpy(interop.scene_to_numpy(js),
                                         device=CPU),
            interop.camera_from_numpy(interop.camera_to_numpy(jc),
                                      device=CPU))


# --- fit_materials(optimize_env=True) ---------------------------------

FIT_ST = dict(ST, samples_per_pixel=1, max_bounces=2, use_envmap=True,
              env_importance_sampling=True, env_mip_level=0)
FIT_LR = 5e-2


@pytest.fixture(scope="module")
def env_fit(tmp_path_factory):
    """The Cornell box under a constant sky, a target from a brighter
    sky, JAX's 3-step fit with optimize_env and its checkpoint after 2."""
    js = jcornell.cornell_box().build(envmap=JEnvmap.constant((0.3, 0.4,
                                                                0.5)))
    bright = jcornell.cornell_box().build(
        envmap=JEnvmap.constant((0.8, 0.7, 0.6)))
    jc, ts, tc = _port(js, CAM)
    st = jht.RenderSettings(**FIT_ST)
    target = np.asarray(jht.render_frame(bright, jc, st, 0))
    jparams, jlosses = jgrad.fit_materials(js, jc, st, jnp.asarray(target),
                                           steps=3, lr=FIT_LR,
                                           optimize_env=True)
    path = str(tmp_path_factory.mktemp("fit") / "env.npz")
    jgrad.fit_materials(js, jc, st, jnp.asarray(target), steps=2, lr=FIT_LR,
                        optimize_env=True, checkpoint_path=path)
    return dict(ts=ts, tc=tc, target=target, jlosses=jlosses, ckpt=path,
                jmats=interop.material_table_to_numpy(jparams["materials"]),
                jenv=[np.asarray(m) for m in jparams["env_mips"]])


def _assert_fit(params, losses, ref, n_losses=3):
    np.testing.assert_allclose(losses, ref["jlosses"][-n_losses:], rtol=1e-4)
    got = interop.material_table_to_numpy(params["materials"])
    for f in FIELDS:
        np.testing.assert_allclose(got[f], ref["jmats"][f], rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    assert len(params["env_mips"]) == len(ref["jenv"])
    for level, (g, r) in enumerate(zip(params["env_mips"], ref["jenv"])):
        assert bool((g >= 0).all()), f"mip {level} below 0"
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-6,
                                   err_msg=f"mip {level}")


def test_fit_materials_optimize_env_matches_jax(env_fit):
    """Three steps of fit_materials(optimize_env=True): the losses, the
    materials and every texel (projected onto >= 0) equal JAX's at rtol
    1e-4; the fit moves the sky."""
    params, losses = tgrad.fit_materials(
        env_fit["ts"], env_fit["tc"], tht.RenderSettings(**FIT_ST),
        env_fit["target"], steps=3, lr=FIT_LR, optimize_env=True)
    _assert_fit(params, losses, env_fit)
    assert not torch.equal(params["env_mips"][0], env_fit["ts"].env_mips[0])
    assert not params["env_mips"][0].requires_grad


def test_env_fit_resumes_from_jax_checkpoint(env_fit):
    """JAX's checkpoint of an env fit after 2 of 3 steps (the mips' leaves
    first, in sorted-key order, then the 7 material fields, Adam's count
    and moments) resumes in the port and ends where JAX's 3-step fit
    ends."""
    data = np.load(env_fit["ckpt"])
    n_mips = len(env_fit["ts"].env_mips)
    n_leaves = n_mips + len(FIELDS)
    assert sorted(data.files) == sorted(
        ["step"] + [f"leaf_{i}" for i in range(3 * n_leaves + 1)])
    assert data["leaf_0"].shape == tuple(env_fit["ts"].env_mips[0].shape)
    params, losses = tgrad.fit_materials(
        env_fit["ts"], env_fit["tc"], tht.RenderSettings(**FIT_ST),
        env_fit["target"], steps=3, lr=FIT_LR, optimize_env=True,
        checkpoint_path=env_fit["ckpt"])
    assert len(losses) == 1
    _assert_fit(params, losses, env_fit, n_losses=1)


def test_render_with_params_takes_the_mips():
    """render_with_params renders with the given mips (a brighter sky, a
    brighter image) and keeps the alias tables as built."""
    js = jcornell.cornell_box().build(envmap=JEnvmap.gradient_sky())
    _, ts, tc = _port(js, CAM)
    st = tht.RenderSettings(**{**ST, "use_envmap": True,
                               "env_importance_sampling": True,
                               "env_mip_level": 0})
    base = tgrad.render_with_params({"materials": ts.materials}, ts, tc, st)
    doubled = tgrad.render_with_params(
        {"env_mips": tuple(2.0 * m for m in ts.env_mips)}, ts, tc, st)
    assert float(doubled.mean()) > float(base.mean())
    same = tgrad.render_with_params({"env_mips": ts.env_mips}, ts, tc, st)
    assert torch.equal(same, base)
