"""The port's gradients of scenes over the brute tier's 128 triangles vs
the JAX package's (`halogen_tpu/diff/grad.py`), on the CPU.

On the card these scenes' backward is the adjoint's BVH tier (B2+d,
B2b+d: its replay walks the world BVH as B1d does); on the CPU both
packages run autograd through their lockstep integrators (with brute-force
hits below 4,096 triangles). The kernels are held to the port's plain
version in `tests/test_torch_adjoint_cuda.py` and `chip_smoke.py`. Scenes
come from the JAX package through `interop`, targets from a numpy seed;
material fields must agree at atol 1e-6, rtol 1e-5, as in
`tests/test_torch_grad.py`.
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)

import halogen_tpu as jht
from halogen_tpu.diff import grad as jgrad
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene import meshes as jmeshes
from halogen_tpu.scene.material import Material as JMaterial
import halogen_tpu_torch as tht
from halogen_tpu_torch import interop
from halogen_tpu_torch.diff import grad as tgrad
from halogen_tpu_torch.kernels import adjoint as adj
from halogen_tpu_torch.kernels import megakernel as mk

CPU = "cpu"  # the port builds on the card unless asked for the CPU
DRAGON_CAM = dict(position=(0, 1.5, 5.0), target=(0, -0.3, 0), fov_deg=45)
ST = dict(width=16, height=16, samples_per_pixel=2, max_bounces=3,
          ray_chunk_size=256)
FIELDS = tgrad.FLOAT_MATERIAL_FIELDS
ATOL, RTOL = 1e-6, 1e-5

_j_loss_grad = jax.jit(jgrad.render_loss_grad.__wrapped__,
                       static_argnames=("settings",))


def _opaque_dragon():
    """The Cornell shell around a 1,280-triangle dragon of rough metal:
    an opaque scene on the BVH tier."""
    s = jcornell.cornell_box(with_spheres=False)
    verts, faces = jmeshes.dragon_mesh(3)
    s.add_mesh(verts, faces, JMaterial.metal((0.9, 0.6, 0.5), roughness=0.4),
               transform=jmeshes._scale_translate(0.55, (0.0, -0.45, 0.0)))
    return s


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


@pytest.mark.parametrize("case", ["glass_dragon", "opaque_dragon"])
def test_big_scene_render_loss_grad_matches_jax(case):
    """Scenes over MAX_TRIS triangles (the kernels' BVH tier): the glass
    dragon at 1,280 triangles (medium stack, absorption) and an opaque
    1,280-triangle dragon, 16x16, 2 spp, 6 bounces."""
    js = (jmeshes.glass_dragon_scene(tris=1280) if case == "glass_dragon"
          else _opaque_dragon()).build()
    kw = dict(max_bounces=6, max_transmission_bounces=6)
    jl, jg, tl, tg = _grads_both(js, DRAGON_CAM, False, **kw)
    ts = _port(js, DRAGON_CAM)[1]
    assert ts.num_triangles > mk.MAX_TRIS and mk.uses_bvh(ts)
    assert adj.adjoint_covers(ts, tht.RenderSettings(**{**ST, **kw}))
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert np.abs(jg["albedo"]).max() > 0 and np.abs(jg["emissive"]).max() > 0
    if case == "glass_dragon":
        assert np.abs(jg["absorption"]).max() > 0
    _assert_fields(tg, jg)
