"""The benchmark's plain reference against the port's plain CPU route, at
tiny sizes: a frame of each configuration's scene, and a loss gradient.
The reference itself imports nothing of the port (checked in a fresh
process); this test does, to compare."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import port  # noqa: E402
from portbench.reference import camera as rc  # noqa: E402
from portbench.reference import fit as rf  # noqa: E402
from portbench.reference import scene as rs  # noqa: E402
from portbench.reference import tracer as rt  # noqa: E402
from portbench.scenes import build  # noqa: E402

import halogen_tpu_torch as ht  # noqa: E402
from halogen_tpu_torch.config import Intersector  # noqa: E402
from halogen_tpu_torch.diff.grad import render_loss_grad  # noqa: E402


def _both(scene_name, w, h, spp, bounces, env, **extra):
    objects, cam = build.load(scene_name)
    image = build.procedural_hdri(64, 5, "cpu") if env else None
    ps = port.scene(objects, image, 6, "cpu")
    pcam = port.camera(cam, w / h, "cpu")
    st = ht.RenderSettings(width=w, height=h, samples_per_pixel=spp,
                           max_bounces=bounces, use_envmap=env,
                           ray_chunk_size=4 * w * h, **extra)
    sc = rs.build_scene(objects, "cpu", image, 6)
    rcam = rc.make_camera(cam, w / h, "cpu")
    rst = rt.settings(dict(width=w, height=h, samples_per_pixel=spp,
                           max_bounces=bounces, use_envmap=env))
    return ps, pcam, st, sc, rcam, rst


def test_reference_frame_equals_the_port_on_cornell():
    ps, pcam, st, sc, rcam, rst = _both("cornell_glossy", 24, 24, 8, 6,
                                        False)
    got = ht.render_frame(ps, pcam, st, 3)
    ref = rt.render_image(sc, rcam, rst, 3, rt.lane_block(24 * 24, 8,
                                                          4 * 24 * 24))
    assert float(ref.mean()) > 0.05
    assert torch.equal(got, ref)


def test_reference_frame_agrees_with_the_port_on_the_testing_scene():
    # the port's CPU route walks the world BVH (the card's route); the
    # reference scans its own hierarchy: the same triangle test, so rays
    # part only where a tie or an ulp turns a path
    w, h = 16, 9
    ps, pcam, st, sc, rcam, rst = _both(
        "testing_scene_active", w, h, 1, 12, True,
        intersector=Intersector.PALLAS)
    got = ht.render_frame(ps, pcam, st, 1)
    ref = rt.render_image(sc, rcam, rst, 1, 1)
    gap = ((got - ref).abs().amax(-1)
           / (ref.abs().amax(-1) + 1e-2)).reshape(-1)
    assert float(ref.mean()) > 0.05
    assert float((gap > 1e-3).float().mean()) <= 0.05
    assert float(torch.quantile(gap, 0.9)) <= 1e-5


def test_reference_gradient_agrees_with_the_port():
    w = 12
    ps, pcam, st, sc, rcam, rst = _both("cornell_glossy", w, w, 4, 6, False)
    target = torch.full((w, w, 3), 0.3)
    params = {"materials": ps.materials}
    loss, grads = render_loss_grad(params, ps, pcam, st, target, 2)
    leaves = {k: sc.materials[k] for k in rs.MATERIAL_KEYS}
    rloss, rgrads = rf.loss_and_grads(sc, rcam, rst, target, 2,
                                      rt.lane_block(w * w, 4, 4 * w * w),
                                      leaves)
    assert abs(float(loss) - rloss) <= 1e-6 * abs(rloss)
    for k in rs.MATERIAL_KEYS:
        np.testing.assert_allclose(rgrads[k].numpy(),
                                   getattr(grads["materials"], k).numpy(),
                                   rtol=1e-4, atol=1e-7)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import portbench.reference.fit, portbench.reference.tracer\n"
            "import portbench.scenes.build, portbench.work\n"
            "print(json.dumps(sorted(sys.modules)))" % str(ROOT))
    mods = json.loads(subprocess.run([sys.executable, "-c", code],
                                     capture_output=True, text=True,
                                     check=True).stdout)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "halogen_tpu",
                       "halogen_tpu_torch"}
