"""The reference's Testing Scene in the port: its fixture builds the JAX
package's inventory, and the `testing_active` golden of the JAX package
(77,364 triangles in 22 meshes, 9 spheres, under the gradient sky)
renders on the CPU within `tests/test_golden.py`'s bounds. On the CPU the
lockstep walks each mesh's BVH, as the JAX package's CPU route does. The
`testing_composite` golden (78,678 triangles, 128x128) is held through
the kernels on the card (`chip_smoke.py` phase 18)."""

import pathlib

import numpy as np
import torch

import halogen_tpu_torch as ht
from halogen_tpu.scene import testing_scene as jtesting
from halogen_tpu_torch import interop
from halogen_tpu_torch.scene import testing_scene as ttesting

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
CPU = "cpu"  # the port builds on the card unless asked for the CPU


def test_testing_scene_inventory():
    """31 spheres + 31 meshes, emissive intensities up to 10.09,
    dielectric priorities {1, 2} in use, as `tests/test_golden.py` pins
    the JAX package's; the camera equals the JAX package's."""
    fix = ttesting.load_fixture()
    assert fix == jtesting.load_fixture()
    assert fix["counts"] == {"spheres": 31, "meshes": 31}
    sc = ttesting.testing_scene(all_groups=True).build(device=CPU)
    assert sc.num_spheres == 31 and sc.num_meshes == 31
    assert sc.num_triangles == 78678
    assert abs(float(sc.materials.emissive[:, 3].max()) - 10.09) < 1e-4
    assert {1, 2} <= set(sc.materials.priority.tolist())
    assert sc.any_transmissive
    ref = interop.camera_to_numpy(jtesting.testing_scene_camera())
    got = interop.camera_to_numpy(ttesting.testing_scene_camera(device=CPU))
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_testing_active_golden():
    """`scripts/gen_goldens.py`'s `testing_active` configuration, at
    `tests/test_golden.py`'s bounds for it (MAE 5e-3, worst pixel 1.0)."""
    golden = np.load(GOLDEN_DIR / "testing_active.npz")["image"]
    scene = ttesting.testing_scene(False).build(
        envmap=ht.Envmap.gradient_sky(), device=CPU)
    assert scene.num_triangles == 77364
    st = ht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                           max_bounces=4, use_envmap=True,
                           ray_chunk_size=4096)
    # The per-mesh walk is many small torch ops: it takes ~37 s on one
    # thread as on four, and more threads only contend with the other
    # test workers.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        img = ht.render_frame(
            scene, ttesting.testing_scene_camera(device=CPU), st, 1).numpy()
    finally:
        torch.set_num_threads(threads)
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert np.abs(img - golden).mean() < 5e-3
    assert np.abs(img - golden).max() < 1.0
