"""PyTorch port vs JAX package: whole frames (Cornell, glass, envmap with
NEE), the four core goldens (the two Cornell ones, `glass_box` and
`envmap_nee`), and the progressive `Renderer` (blend, camera reset, done
latch, checkpoints), as `tests/test_render_state.py` checks the JAX
package.

Frames: per pixel atol = rtol = 1e-5, with at most 1 pixel in 256
outside (a rare Russian-roulette or edge decision flipped by an ulp of
torch's vs XLA's transcendentals; see test_torch_megakernel.py).
"""

import os
import pathlib

import numpy as np
import jax
import pytest
import torch

import halogen_tpu as jht
import halogen_tpu_torch as tht
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene.envmap import Envmap as JEnvmap
from halogen_tpu_torch import interop
from halogen_tpu_torch.integrator.trace import _morton_pixel_order
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.scene import cornell as tcornell

CPU = "cpu"  # the port builds on the card unless asked for the CPU

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
SKY_CAM = dict(position=(0, 1.0, 6.0), target=(0, 0.5, 0), fov_deg=40)

_j_render = jax.jit(jht.render_frame, static_argnames=("settings",))


@pytest.mark.parametrize("glossy,spp,chunk", [(True, 2, 256), (False, 2, 100)])
def test_render_frame_matches_jax(glossy, spp, chunk):
    kw = dict(width=16, height=16, samples_per_pixel=spp, max_bounces=4,
              ray_chunk_size=chunk)
    jscene = jcornell.cornell_box(glossy=glossy).build()
    jcam = jht.make_camera(**CAM)
    ref = np.asarray(_j_render(jscene, jcam, jht.RenderSettings(**kw), 3))

    scene = interop.scene_from_numpy(interop.scene_to_numpy(jscene), device=CPU)
    cam = interop.camera_from_numpy(interop.camera_to_numpy(jcam), device=CPU)
    got = tht.render_frame(scene, cam, tht.RenderSettings(**kw), 3).numpy()
    assert got.shape == ref.shape == (16, 16, 3)
    bad = (np.abs(got - ref) > 1e-5 + 1e-5 * np.abs(ref)).any(axis=-1)
    assert bad.sum() <= bad.size // 256, (
        f"{bad.sum()} pixels outside 1e-5; max {np.abs(got - ref).max()}")


@pytest.mark.parametrize("name", ["glass", "env_nee"])
def test_slice_render_frame_matches_jax(name):
    """render_frame on the glass box (8 bounces, the stack) and on the
    material spheres under the sky with env NEE, in both packages."""
    kw = dict(width=16, height=16, samples_per_pixel=2, ray_chunk_size=128)
    if name == "glass":
        jscene = jcornell.glass_sphere_box().build()
        cam_kw = CAM
        kw.update(max_bounces=8, max_transmission_bounces=8)
    else:
        jscene = jcornell.material_demo_spheres().build(
            envmap=JEnvmap.gradient_sky())
        cam_kw = SKY_CAM
        kw.update(max_bounces=4, use_envmap=True,
                  env_importance_sampling=True)
    ref = np.asarray(_j_render(jscene, jht.make_camera(**cam_kw),
                               jht.RenderSettings(**kw), 2))
    scene = interop.scene_from_numpy(interop.scene_to_numpy(jscene), device=CPU)
    got = tht.render_frame(scene, tht.make_camera(**cam_kw, device=CPU),
                           tht.RenderSettings(**kw), 2).numpy()
    assert got.shape == ref.shape == (16, 16, 3)
    bad = (np.abs(got - ref) > 1e-5 + 1e-5 * np.abs(ref)).any(axis=-1)
    assert bad.sum() <= max(1, bad.size // 256), (
        f"{bad.sum()} pixels outside 1e-5; max {np.abs(got - ref).max()}")


@pytest.mark.parametrize("fused", ["AUTO", "FORCE"])
def test_scene_over_kernel_caps_renders_on_cpu(fused):
    """36 spheres is over the megakernel's cap; on the CPU the lockstep
    integrator renders it under every `fused` setting, as the JAX package
    does with its kernel off."""
    kw = dict(width=8, height=8, samples_per_pixel=2, max_bounces=3,
              ray_chunk_size=64)
    cam_kw = dict(position=(0, 2, 6), target=(0, 0.5, -3), fov_deg=50)
    jscene = jcornell.material_demo_spheres(rows=6, cols=6).build()
    ref = np.asarray(_j_render(
        jscene, jht.make_camera(**cam_kw),
        jht.RenderSettings(**kw, fused=jht.Fused.OFF,
                           intersector=jht.Intersector.BRUTE), 2))

    scene = tcornell.material_demo_spheres(rows=6, cols=6).build(device=CPU)
    assert scene.num_spheres == 36
    assert not mk.fused_supported(scene, tht.RenderSettings(**kw))
    before = mk.LAUNCHES
    got = tht.render_frame(scene, tht.make_camera(**cam_kw, device=CPU),
                           tht.RenderSettings(**kw, fused=tht.Fused[fused]),
                           2).numpy()
    assert mk.LAUNCHES == before
    bad = (np.abs(got - ref) > 1e-5 + 1e-5 * np.abs(ref)).any(axis=-1)
    assert bad.sum() <= max(1, bad.size // 256)


def test_morton_order_is_a_permutation():
    perm, inv = _morton_pixel_order(12, 8)
    assert sorted(perm.tolist()) == list(range(96))
    np.testing.assert_array_equal(perm[inv], np.arange(96))


def _golden_configs():
    """The port's own build of `scripts/gen_goldens.py`'s four core
    fixtures (ladder 1-4)."""
    cam = tht.make_camera(**CAM, device=CPU)
    return {
        "envmap_nee": (
            tcornell.material_demo_spheres().build(
                envmap=tht.Envmap.gradient_sky(), device=CPU),
            tht.make_camera(**SKY_CAM, device=CPU),
            tht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                               max_bounces=4, use_envmap=True,
                               env_importance_sampling=True,
                               ray_chunk_size=4096), 1),
        "glass_box": (
            tcornell.glass_sphere_box().build(device=CPU), cam,
            tht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                               max_bounces=8, max_transmission_bounces=8,
                               ray_chunk_size=4096), 1),
        "cornell_diffuse": (
            tcornell.cornell_box().build(device=CPU), cam,
            tht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                               max_bounces=2, ray_chunk_size=4096), 1),
        "cornell_glossy_dof": (
            tcornell.cornell_box(glossy=True).build(device=CPU),
            tht.make_camera(**CAM, aperture_deg=2.0, focal_distance=3.2, device=CPU),
            tht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                               max_bounces=4, ray_chunk_size=4096), 1),
    }


@pytest.mark.parametrize("name", ["cornell_diffuse", "cornell_glossy_dof",
                                  "envmap_nee", "glass_box"])
def test_golden_image(name):
    """The JAX package's golden frames, at `tests/test_golden.py`'s bounds."""
    golden = np.load(GOLDEN_DIR / f"{name}.npz")["image"]
    scene, cam, st, frame = _golden_configs()[name]
    img = tht.render_frame(scene, cam, st, frame).numpy()
    assert img.shape == golden.shape
    assert np.isfinite(img).all()
    assert np.abs(img - golden).mean() < 5e-3
    assert np.abs(img - golden).max() < 0.15


ST = tht.RenderSettings(width=16, height=16, samples_per_pixel=2,
                        max_bounces=2, ray_chunk_size=256,
                        max_accumulated_frames=4, unlimited_sampling=False)


@pytest.fixture(scope="module")
def scene():
    return tcornell.cornell_box().build(device=CPU)


def test_blend_is_running_mean(scene):
    cam = tht.make_camera(**CAM, device=CPU)
    r = tht.Renderer(scene, cam, ST)
    r.render(3)
    frames = [tht.render_frame(scene, cam, ST, f).numpy() for f in (1, 2, 3)]
    np.testing.assert_allclose(r.image, np.mean(frames, axis=0),
                               atol=1e-6, rtol=1e-6)
    assert int(r.state.frame_count) == 4


def test_done_latch_stops_accumulation(scene):
    r = tht.Renderer(scene, tht.make_camera(**CAM, device=CPU), ST)
    for _ in range(10):
        r.step()
    assert r.done
    assert int(r.state.frame_count) == ST.max_accumulated_frames + 1
    img_before = r.image.copy()
    r.step()
    np.testing.assert_array_equal(r.image, img_before)


def test_camera_move_resets(scene):
    r = tht.Renderer(scene, tht.make_camera(**CAM, device=CPU), ST)
    r.step()
    r.step()
    assert int(r.state.frame_count) == 3
    moved = tht.make_camera(position=(0.1, 0, 3.2), target=(0, 0, 0),
                            fov_deg=40, device=CPU)
    r.set_camera(moved)
    assert int(r.state.frame_count) == 1
    r.set_camera(moved)  # same camera: no reset
    r.step()
    assert int(r.state.frame_count) == 2


def test_checkpoint_roundtrip(scene, tmp_path):
    cam = tht.make_camera(**CAM, device=CPU)
    r = tht.Renderer(scene, cam, ST)
    r.step()
    r.step()
    path = os.path.join(tmp_path, "ckpt.npz")
    r.save_checkpoint(path)
    r2 = tht.Renderer(scene, cam, ST)
    r2.load_checkpoint(path)
    assert int(r2.state.frame_count) == int(r.state.frame_count)
    np.testing.assert_array_equal(r2.image, r.image)
    r.step()
    r2.step()
    np.testing.assert_array_equal(r2.image, r.image)


def test_unlimited_and_accumulate_off(scene):
    cam = tht.make_camera(**CAM, device=CPU)
    r = tht.Renderer(scene, cam, ST.replace(unlimited_sampling=True))
    for _ in range(ST.max_accumulated_frames + 2):
        r.step()
    assert not r.done
    r = tht.Renderer(scene, cam, ST.replace(accumulate=False))
    a = r.step()
    b = r.step()
    np.testing.assert_array_equal(a, b)
    assert int(r.state.frame_count) == 1


def test_renderer_matches_jax_renderer():
    """Two accumulated frames of the README entry point in both packages."""
    kw = dict(width=16, height=16, samples_per_pixel=2, max_bounces=3,
              ray_chunk_size=512)
    jr = jht.Renderer(jcornell.cornell_box(glossy=True).build(),
                      jht.make_camera(**CAM), jht.RenderSettings(**kw))
    tr = tht.Renderer(tcornell.cornell_box(glossy=True).build(device=CPU),
                      tht.make_camera(**CAM, device=CPU), tht.RenderSettings(**kw))
    ref, got = jr.render(2), tr.render(2)
    bad = (np.abs(got - ref) > 1e-5 + 1e-5 * np.abs(ref)).any(axis=-1)
    assert bad.sum() <= bad.size // 256
    assert int(tr.state.frame_count) == int(jr.state.frame_count) == 3


def test_no_jax_in_the_port():
    """Importing the port (and driving it, a big scene's BVH routes too)
    loads neither JAX nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys, halogen_tpu_torch as ht\n"
        "from halogen_tpu_torch.scene import cornell, meshes, testing_scene\n"
        "from halogen_tpu_torch.kernels import megakernel, traverse\n"
        "from halogen_tpu_torch.accel import build_bvh, native_loader\n"
        "s = cornell.cornell_box().build(device='cpu')\n"
        "st = ht.RenderSettings(width=4, height=4, max_bounces=1)\n"
        "ht.render_frame(s, ht.make_camera(device='cpu'), st)\n"
        "b = meshes.dragons_hero_scene(1, tris=320).build(device='cpu')\n"
        "for i in (ht.Intersector.AUTO, ht.Intersector.RAYLET):\n"
        "    ht.render_frame(b, ht.make_camera(device='cpu'), st.replace(\n"
        "        intersector=i, brute_force_max_tris=64))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'halogen_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
