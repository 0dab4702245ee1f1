"""Area-light next-event estimation in the port's lockstep integrator (the
plain version of the megakernel's light-NEE variant, B1e) against the JAX
package's lockstep, on the CPU: whole frames of the opaque scenes of
`tests/test_light_nee.py` (the Cornell panel, Cornell glossy, the Glow
Orbs' sphere emitters, the blocked plate; the glass, sky and big-mesh
frames are in `tests/test_torch_light_nee_glass_sky.py`, the gradient in
`tests/test_torch_light_nee_grad.py`), at `tests/light_nee_cases.py`'s
bound; the direct view of an emitter (MIS weight 1); and a scene with the
flag and no emitter (the flag-off image, bit for bit). The CUDA kernel
itself is held to this plain version in `tests/test_torch_kernel_cuda.py`.
"""

import numpy as np
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)
import torch

import halogen_tpu_torch as tht
from halogen_tpu_torch.integrator.trace import _use_light_nee
from halogen_tpu_torch.kernels import adjoint as adj
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.scene import cornell as tcornell
from halogen_tpu_torch.scene.material import Material
from light_nee_cases import BASE, CAM, CPU, check_frame_matches_jax


@pytest.mark.parametrize("name", ["blocked_plate", "cornell",
                                  "cornell_glossy", "glow_orbs"])
def test_light_nee_frame_matches_jax(name):
    check_frame_matches_jax(name)


def test_direct_view_weight_one():
    """tests/test_light_nee.py:27-42: a camera ray that meets the panel
    directly shows its full emission (no previous bounce, weight 1), and
    at 0 bounces the NEE image equals the plain one bit for bit."""
    s = tcornell.Scene()
    v = np.array([(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)],
                 np.float32)
    s.add_mesh(v, np.array([[0, 1, 2], [0, 2, 3]], np.int32),
               Material.emissive((1.0, 0.5, 0.25), 2.0))
    scene = s.build(device=CPU)
    cam = tht.make_camera(**CAM, device=CPU)
    st = tht.RenderSettings(**{**BASE, "max_bounces": 0,
                               "samples_per_pixel": 1,
                               "light_importance_sampling": False})
    a = tht.render_frame(scene, cam, st, 1).numpy()
    b = tht.render_frame(scene, cam, st.replace(
        light_importance_sampling=True), 1).numpy()
    np.testing.assert_allclose(a[12, 12], [2.0, 1.0, 0.5], rtol=1e-4)
    np.testing.assert_array_equal(a, b)


def test_flag_without_emitters_is_the_plain_image():
    """The JAX predicate: light NEE needs the flag and a light table. A
    scene without emitters renders with the flag (it raised before) and
    gives the flag-off image bit for bit, on the lockstep and through the
    kernel module's plain route."""
    scene = tcornell.material_demo_spheres(rows=1, cols=3).build(
        envmap=tht.Envmap.gradient_sky(), device=CPU)
    assert scene.lights is None
    cam = tht.make_camera(position=(0, 1, 6), target=(0, 0.5, 0),
                          fov_deg=40, device=CPU)
    st = tht.RenderSettings(width=16, height=16, samples_per_pixel=2,
                            max_bounces=3, use_envmap=True,
                            env_importance_sampling=True)
    on = st.replace(light_importance_sampling=True)
    assert not _use_light_nee(scene, on) and mk.fused_supported(scene, on)
    assert adj.adjoint_covers(scene, on)
    for fused in (tht.Fused.OFF, tht.Fused.AUTO):
        a = tht.render_frame(scene, cam, st.replace(fused=fused), 1)
        b = tht.render_frame(scene, cam, on.replace(fused=fused), 1)
        assert torch.equal(a, b)
