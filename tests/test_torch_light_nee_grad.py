"""The gradient of area-light NEE on the CPU: `render_loss_grad` through
the port's light-NEE lockstep against `jax.grad` of the JAX lockstep, at
`tests/test_torch_grad.py`'s atol 1e-6, rtol 1e-5; and the fused adjoint,
which has no light-NEE variant yet, refusing it naming ROADMAP B2+l (on
the card `render_loss_grad` refuses it before any launch:
`tests/test_torch_kernel_cuda.py`)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)
import torch

import halogen_tpu as jht
from halogen_tpu.diff import grad as jgrad
from halogen_tpu.scene import cornell as jcornell
import halogen_tpu_torch as tht
from halogen_tpu_torch import interop
from halogen_tpu_torch.diff import grad as tgrad
from halogen_tpu_torch.kernels import adjoint as adj
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.scene import cornell as tcornell

CPU = "cpu"
CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)


def test_render_loss_grad_matches_jax():
    """Autograd through the light-NEE lockstep on the CPU against
    `jax.grad` of the JAX lockstep: the emission of the lights reaches the
    image through every NEE term, so d emissive is dense."""
    js = jcornell.cornell_box().build()
    jc = jht.make_camera(**CAM)
    ts = interop.scene_from_numpy(interop.scene_to_numpy(js), device=CPU)
    tc = interop.camera_from_numpy(interop.camera_to_numpy(jc), device=CPU)
    kw = dict(width=16, height=16, samples_per_pixel=4, max_bounces=3,
              ray_chunk_size=256, light_importance_sampling=True)
    target = np.random.default_rng(0).uniform(
        0.0, 1.0, (16, 16, 3)).astype(np.float32)
    jl, jg = jax.jit(jgrad.render_loss_grad.__wrapped__,
                     static_argnames=("settings",))(
        {"materials": js.materials}, js, jc, jht.RenderSettings(**kw),
        jnp.asarray(target), 1)
    tl, tg = tgrad.render_loss_grad({"materials": ts.materials}, ts, tc,
                                    tht.RenderSettings(**kw), target, 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got = interop.material_table_to_numpy(tg["materials"])
    ref = interop.material_table_to_numpy(jg["materials"])
    assert np.abs(ref["emissive"]).max() > 0
    for f in tgrad.FLOAT_MATERIAL_FIELDS:
        np.testing.assert_allclose(got[f], ref[f], atol=1e-6, rtol=1e-5,
                                   err_msg=f)


def test_adjoint_refuses_light_nee_naming_its_item():
    """The fused adjoint has no light-NEE variant yet: its entry points
    refuse the setting, naming ROADMAP B2+l, on either device."""
    scene = tcornell.cornell_box().build(device=CPU)
    st = tht.RenderSettings(width=4, height=4, light_importance_sampling=True)
    assert mk.fused_supported(scene, st) and not adj.adjoint_covers(scene, st)
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(2, 1)
    with pytest.raises(NotImplementedError, match="B2\\+l"):
        adj.trace_grad_fused_materials(scene, o, d, torch.tensor(10.0), 0, 1,
                                       torch.ones((2, 3)), st)
