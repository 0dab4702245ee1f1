"""The light-NEE frame cases that `tests/test_torch_light_nee.py` and
`tests/test_torch_light_nee_glass_sky.py` hold the port's lockstep to the
JAX package's lockstep on (imported by them; not a test module).

Frames: per pixel atol = rtol = 1e-5 (`tests/test_megakernel.py:60`), at
most 1 pixel in 256 outside (an ulp of torch's vs XLA's transcendentals,
or an FMA that XLA contracts in a mesh scene's Moller-Trumbore, flips a
rare decision; see test_torch_megakernel.py and test_torch_intersect.py).
The glossy Cornell box is held apart: its metal sphere's roughness-0.1
lobe has a glossy pdf that grows without bound toward the rim of its
support, and the NEE term's weight p_gl / (pdf_light + p_mix) there turns
an ulp of the light direction (a point on the panel minus the hit, which
XLA may round with a fused multiply-add) into up to ~2e-3 of the pixel
(3 of 576 pixels measured, each within 1.8e-3 relative). There at most
1 pixel in 64 may fall outside 1e-5, and those within 5e-3 relative.
"""

import numpy as np
import jax

import halogen_tpu as jht
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene import meshes as jmeshes
from halogen_tpu.scene.envmap import Envmap as JEnvmap
from halogen_tpu.scene.material import Material as JMaterial
import halogen_tpu_torch as tht
from halogen_tpu_torch import interop
from halogen_tpu_torch.integrator.trace import _use_light_nee
from halogen_tpu_torch.kernels import megakernel as mk

CPU = "cpu"
CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
BASE = dict(width=24, height=24, samples_per_pixel=2, max_bounces=4,
            ray_chunk_size=576, light_importance_sampling=True)

_j_render = jax.jit(jht.render_frame, static_argnames=("settings",))


def _blocked_plate():
    """tests/test_light_nee.py:74-92: a dark plate between the floor and
    the panel."""
    s = jcornell.cornell_box(with_spheres=False)
    v = np.array([(-0.5, 0.2, -0.5), (0.5, 0.2, -0.5), (0.5, 0.2, 0.5),
                  (-0.5, 0.2, 0.5)], np.float32)
    s.add_mesh(v, np.array([[0, 1, 2], [0, 2, 3]], np.int32),
               JMaterial.diffuse((0.1, 0.1, 0.1)))
    return s


# name -> (JAX scene, settings beyond BASE)
SCENES = {
    "cornell": (lambda: jcornell.cornell_box().build(), {}),
    # the metal sphere's near-mirror lobe under light NEE (see above)
    "cornell_glossy": (lambda: jcornell.cornell_box(glossy=True).build(),
                       dict(max_bounces=3)),
    "glow_orbs": (lambda: jcornell.glow_orbs().build(),
                  dict(samples_per_pixel=4)),
    "blocked_plate": (lambda: _blocked_plate().build(), dict(max_bounces=2)),
    # glass lanes take no NEE; the panel lights the box through the sphere
    "glass_box": (lambda: jcornell.glass_sphere_box().build(),
                  dict(max_bounces=4, max_transmission_bounces=4)),
    # env NEE and light NEE in one bounce, env first
    "sky_env_light": (lambda: jcornell.cornell_box().build(
        envmap=JEnvmap.gradient_sky()),
        dict(max_bounces=3, use_envmap=True, env_importance_sampling=True,
             env_mip_level=0)),
    # 20 * 4^2 = 320 dragon triangles in the Cornell shell: over the
    # megakernel's brute tier (B1e's BVH tier on the card)
    "dragon_320": (lambda: jmeshes.glass_dragon_scene(tris=320).build(),
                   dict(max_bounces=3, max_transmission_bounces=3)),
}


def check_frame_matches_jax(name):
    """The port's light-NEE frame of SCENES[name] against the JAX
    package's, at the bound above; and light NEE changed the image (a flag
    that did nothing would pass only if JAX ignored it too)."""
    make, kw = SCENES[name]
    jscene = make()
    kw = {**BASE, **kw}
    ref = np.asarray(_j_render(jscene, jht.make_camera(**CAM),
                               jht.RenderSettings(**kw), 2))
    scene = interop.scene_from_numpy(interop.scene_to_numpy(jscene),
                                     device=CPU)
    st = tht.RenderSettings(**kw)
    cam = tht.make_camera(**CAM, device=CPU)
    got = tht.render_frame(scene, cam, st, 2).numpy()
    assert _use_light_nee(scene, st) and mk.fused_supported(scene, st)
    assert mk.uses_bvh(scene) == (name == "dragon_320")
    assert got.shape == ref.shape == (24, 24, 3)
    assert np.isfinite(got).all() and got.max() > 0.0
    bad = (np.abs(got - ref) > 1e-5 + 1e-5 * np.abs(ref)).any(axis=-1)
    share = 64 if name == "cornell_glossy" else 256
    assert bad.sum() <= max(1, bad.size // share), (
        f"{bad.sum()} pixels outside 1e-5; max {np.abs(got - ref).max()}")
    if name == "cornell_glossy":
        np.testing.assert_allclose(got, ref, rtol=5e-3, atol=1e-5)
    off = tht.render_frame(scene, cam,
                           st.replace(light_importance_sampling=False),
                           2).numpy()
    assert np.abs(off - got).max() > 1e-3
