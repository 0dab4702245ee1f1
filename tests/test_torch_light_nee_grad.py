"""The gradient of area-light NEE on the CPU: `render_loss_grad` through
the port's light-NEE lockstep against `jax.grad` of the JAX lockstep, at
`tests/test_torch_grad.py`'s atol 1e-6, rtol 1e-5; and the fused
adjoint's light-NEE route (B2+l), which records and sweeps and has no
replay: on the CPU its entry points give the plain version's gradient;
they refuse a replay, and the plan records each launch again in its
backward past the budget, raising only where one launch's record does
not fit (on the card: `tests/test_torch_kernel_cuda.py`)."""

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
    """The fused adjoint covers light NEE (B2+l) by recording only: on the
    CPU its entry point gives the plain version's gradient (the lockstep's
    light NEE, whose emitter gets a d emission); a light-NEE replay is
    refused, and the plan takes the route that records each launch again
    ('rerecord') where the step's records pass the budget but one
    launch's fits, and refuses, before any launch, naming the launch's
    bytes and `ray_chunk_size`, where even that does not fit."""
    scene = tcornell.cornell_box().build(device=CPU)
    st = tht.RenderSettings(width=4, height=4, light_importance_sampling=True)
    assert mk.fused_supported(scene, st) and adj.adjoint_covers(scene, st)
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, -1.0, 0.0], [0.3, -0.8, -0.5]])
    d = d / d.norm(dim=1, keepdim=True)
    args = (scene, o, d, torch.tensor(10.0), 0, 1, torch.ones((2, 3)), st)
    got = adj.trace_grad_fused_materials(*args)
    ref = adj.trace_grad_fused_materials_reference(*args)
    assert torch.equal(got, ref)
    light = int(scene.tri_material[int(scene.lights.idx[0])])
    assert float(got[light, 0:3].abs().max()) > 0  # the panel's d emission
    before = mk.LAUNCHES, adj.LAUNCHES, adj.SWEEP_LAUNCHES
    with pytest.raises(ValueError, match="no replay"):
        adj._launch(*args[:7], st, None, route="global")
    one = adj.record_bytes(scene, st, 2)
    live = mk.live_record_bytes(CPU)
    assert adj.record_plan(scene, st, 2, 3, live + 3 * one) == "recorded"
    assert adj.record_plan(scene, st, 2, 3, live + one) == "rerecord"
    with pytest.raises(NotImplementedError, match="ray_chunk_size") as e:
        adj.record_plan(scene, st, 2, 1, budget=0)
    assert str(one) in str(e.value)
    assert (mk.LAUNCHES, adj.LAUNCHES, adj.SWEEP_LAUNCHES) == before
