"""The port's wavefront scheduler (`trace_rays_wavefront`, selected by
`RenderSettings.wavefront` wherever the lockstep runs): the four cases of
`tests/test_wavefront.py` (scenes, block invariance, gradients, a pool
that does not divide into blocks), a debug view on a world-BVH
intersector, and the per-mesh walk under rotated instances in small
blocks.

Against the port's lockstep the image is equal bit for bit (each ray sees
the same operations in another slot), and so are the debug views'
per-ray counts; the gradients (a trace that wants one runs the lockstep) are
held at `tests/test_wavefront.py`'s rtol 1e-6, atol 1e-7 and the loss bit
for bit. Against the JAX package's `render_frame(..., wavefront=True)` on
the same scene, camera and settings: per pixel atol = rtol = 1e-5, with
at most 1 pixel in 256 outside, as `tests/test_torch_render.py` holds
the lockstep.
"""

import dataclasses

import numpy as np
import jax
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)
import torch

import halogen_tpu as jht
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene.envmap import Envmap as JEnvmap
import halogen_tpu_torch as tht
from halogen_tpu_torch import interop
from halogen_tpu_torch.diff import render_loss_grad
from halogen_tpu_torch.integrator import trace
from halogen_tpu_torch.core.math import (
    transform_dir,
    transform_dir_rows,
    transform_point_rows,
)
from halogen_tpu_torch.scene import meshes, testing_scene
from halogen_tpu_torch.scene.envmap import Envmap

CPU = "cpu"  # the port builds on the card unless asked for the CPU
CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
ST = dict(width=12, height=12, samples_per_pixel=2, max_bounces=6,
          ray_chunk_size=144, wavefront_block=64)

_j_render = jax.jit(jht.render_frame, static_argnames=("settings",))


def _scene(name):
    """(JAX scene, port scene, extra settings) of `tests/test_wavefront.py`'s
    three scene classes."""
    if name == "cornell":
        js, kw = jcornell.cornell_box().build(), {}
    elif name == "glass":
        js = jcornell.glass_sphere_box().build()
        kw = dict(max_bounces=12, max_transmission_bounces=12)
    else:
        js = jcornell.material_demo_spheres().build(
            envmap=JEnvmap.gradient_sky())
        kw = dict(use_envmap=True, env_importance_sampling=True,
                  env_mip_level=0)
    return js, interop.scene_from_numpy(interop.scene_to_numpy(js),
                                        device=CPU), kw


def _vs_jax(got, ref):
    assert got.shape == ref.shape
    bad = (np.abs(got - ref) > 1e-5 + 1e-5 * np.abs(ref)).any(axis=-1)
    assert bad.sum() <= max(1, bad.size // 256), (
        f"{bad.sum()} pixels outside 1e-5; max {np.abs(got - ref).max()}")


@pytest.mark.parametrize("name", ["cornell", "glass", "sky"])
def test_wavefront_matches_lockstep(name):
    js, scene, kw = _scene(name)
    cam = tht.make_camera(**CAM, device=CPU)
    st = tht.RenderSettings(**{**ST, **kw})
    a = tht.render_frame(scene, cam, st, 1)
    trace.WAVEFRONT_SYNCS = 0
    b = tht.render_frame(scene, cam, st.replace(wavefront=True), 1)
    assert torch.equal(a, b)
    # one host sync a bounce at most, in each of the frame's two groups
    assert 0 < trace.WAVEFRONT_SYNCS <= 2 * (st.max_bounces + 1)
    jst = jht.RenderSettings(**{**ST, **kw}, wavefront=True)
    ref = np.asarray(_j_render(js, jht.make_camera(**CAM), jst, 1))
    _vs_jax(b.numpy(), ref)


def test_wavefront_block_size_invariance():
    _, scene, _ = _scene("cornell")
    cam = tht.make_camera(**CAM, device=CPU)
    st = tht.RenderSettings(**ST, wavefront=True)
    a = tht.render_frame(scene, cam, st.replace(wavefront_block=16), 1)
    b = tht.render_frame(scene, cam, st.replace(wavefront_block=1024), 1)
    c = tht.render_frame(scene, cam, st.replace(wavefront_block=1), 1)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_wavefront_gradients_match_lockstep():
    """The flag under autograd (the trace runs the lockstep, whose forward
    is the wavefront's bit for bit): the loss bit for bit, the material
    and mip gradients at rtol 1e-6, atol 1e-7."""
    _, scene, kw = _scene("sky")
    cam = tht.make_camera(**CAM, device=CPU)
    st = tht.RenderSettings(**{**ST, "max_bounces": 4, **kw})
    target = tht.render_frame(scene, cam, st, 7) * 0.8
    params = {"materials": scene.materials, "env_mips": scene.env_mips}
    loss_a, g_a = render_loss_grad(params, scene, cam, st, target, 1)
    loss_b, g_b = render_loss_grad(params, scene, cam,
                                   st.replace(wavefront=True), target, 1)
    assert torch.equal(loss_a, loss_b)
    pairs = [(f.name, getattr(g_a["materials"], f.name),
              getattr(g_b["materials"], f.name))
             for f in dataclasses.fields(g_a["materials"])]
    pairs += [(f"mip {i}", a, b)
              for i, (a, b) in enumerate(zip(g_a["env_mips"],
                                             g_b["env_mips"]))]
    assert any(bool((a != 0).any()) for _, a, _ in pairs)
    for name, a, b in pairs:
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_wavefront_nondivisible_pool():
    """221 rays a group in blocks of 100: the 79 padded lanes must not
    reach the image, here or in the JAX package's."""
    js, scene, _ = _scene("cornell")
    kw = dict(ST, width=17, height=13, ray_chunk_size=221,
              wavefront_block=100)
    cam = tht.make_camera(**CAM, device=CPU)
    st = tht.RenderSettings(**kw)
    a = tht.render_frame(scene, cam, st, 1)
    b = tht.render_frame(scene, cam, st.replace(wavefront=True), 1)
    assert torch.equal(a, b)
    ref = np.asarray(_j_render(js, jht.make_camera(**CAM),
                               jht.RenderSettings(**kw, wavefront=True), 1))
    _vs_jax(b.numpy(), ref)


@pytest.mark.parametrize("intersector", ["PALLAS", "BVH"])
def test_wavefront_debug_view_counts(intersector):
    """Two dragons under the sky (the medium stack of the glass one too)
    in the combined heatmap, through the world BVH's walk (PALLAS) and
    the per-mesh walk (BVH), on a pool that does not divide into blocks:
    every TraceOut field, the per-ray counts among them, and the view
    equal to the lockstep's."""
    scene = meshes.dragons_hero_scene(2, tris=320).build(
        envmap=Envmap.gradient_sky(), device=CPU)
    cam = tht.make_camera(position=(0, 1.5, 5.0), target=(0, -0.3, 0),
                          fov_deg=45, device=CPU)
    st = tht.RenderSettings(
        width=13, height=11, samples_per_pixel=1, max_bounces=4,
        use_envmap=True, wavefront_block=50, brute_force_max_tris=64,
        intersector=tht.Intersector[intersector],
        debug_mode=tht.DebugMode.COMBINED)
    pix = torch.arange(st.num_pixels)
    o, d, sidx, seed = trace.group_rays(cam, st, 1, pix, 0, 1)
    far = cam.far.expand(o.shape[0])
    a = trace.trace_rays(scene, o, d, far, sidx, seed, st)
    b = trace.trace_rays_wavefront(scene, o, d, far, sidx, seed, st)
    for field, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), field
    assert int(a.tri_tests.sum()) > 0 and int(a.box_tests.sum()) > 0
    img_a = tht.render_frame(scene, cam, st, 1)
    img_b = tht.render_frame(scene, cam, st.replace(wavefront=True), 1)
    assert torch.equal(img_a, img_b)


def test_wavefront_rows_keep_their_bits_in_small_blocks():
    """The per-mesh walk's rotated instances (testing_scene's active set)
    in blocks of one ray: the compacted batches fall to a few rows, where
    a BLAS `p @ M.T` rounds a row apart from the whole batch's product,
    so the walk transforms rays elementwise (`transform_point_rows`)."""
    g = torch.Generator().manual_seed(0)
    p = torch.randn(300, 3, generator=g) * 10
    m = torch.randn(4, 4, generator=g)
    full_pt, full_dir = transform_point_rows(m, p), transform_dir_rows(m, p)
    for n in (1, 2, 3, 7, 8, 100):
        assert torch.equal(transform_point_rows(m, p[:n]), full_pt[:n])
        assert torch.equal(transform_dir_rows(m, p[:n]), full_dir[:n])
    torch.testing.assert_close(full_dir, transform_dir(m, p))
    scene = testing_scene.testing_scene(False).build(device=CPU)
    cam = testing_scene.testing_scene_camera(device=CPU)
    st = tht.RenderSettings(width=9, height=7, samples_per_pixel=1,
                            max_bounces=6, wavefront_block=1,
                            intersector=tht.Intersector.BVH)
    o, d, sidx, seed = trace.group_rays(cam, st, 1,
                                        torch.arange(st.num_pixels), 0, 1)
    far = cam.far.expand(o.shape[0])
    a = trace.trace_rays(scene, o, d, far, sidx, seed, st)
    b = trace.trace_rays_wavefront(scene, o, d, far, sidx, seed, st)
    for field, x, y in zip(a._fields, a, b):
        assert (x is None and y is None) or torch.equal(x, y), field
