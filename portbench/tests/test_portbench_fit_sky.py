"""The `fit_sky` entry and its reference (`testing_fit`): the reference
follows the program's material-and-sky fit from the start; the control
and the three faults read not correct; a run is correct, and not correct
where the program's sky gradient is mirrored or its loss leaves half of
the batch out; the new readers read only such a run's trace. At tiny sizes on the CPU (the resolution, the spp and
the HDRI's width shrunk, as `test_portbench_control.tiny_cell` does),
where the port runs its plain route."""

import copy
import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import control_fit_sky, harness  # noqa: E402

SEED = 4000000019


def tiny_cell():
    cell = harness.find_cell(ROOT, "testing_fit")
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["settings"].update(width=8, height=6, samples_per_pixel=4)
    cell.traffic["target_spp"] = 2
    cell.config = dict(cell.config, envmap=dict(cell.config["envmap"],
                                                width=64))
    return cell


def _past(readings: dict, limits: dict) -> list:
    return sorted(k for k, v in limits.items() if readings[k] > v)


def test_the_reference_follows_the_sky_fit_from_the_start():
    # the reference takes every step from the start, as the program does;
    # both sides run plain PyTorch here, the same taps summed in another
    # order (the port's deferred sky and its index_add; the reference's
    # gathers' backward), so every number agrees to rounding: the loss to
    # 1e-6, each leaf's gradient texel by texel to 1e-4 of its norm, each
    # leaf's norms of gradient and change to 1e-4 (the cell's limits are
    # set for the card, where the two BVH walks part on a few paths)
    from halogen_tpu_torch.diff.grad import fit_materials

    from portbench import common, port
    from portbench.entries import fit, fit_sky
    from portbench.reference import fit_sky as ref
    from portbench.reference import tracer as ref_tracer
    from portbench.scenes import build

    cell, steps, dev = tiny_cell(), 3, "cpu"
    st = common.settings(cell)
    objects, cam_spec, image = common.inputs(cell, SEED, dev)
    start_image = build.procedural_hdri(64, SEED + 1, dev)
    rsc, rcam, rst = common.reference(
        cell, fit.draw_materials(objects, SEED, 1), cam_spec, image, st, dev)
    target = ref_tracer.render_image(
        rsc, rcam, dict(rst, samples_per_pixel=cell.traffic["target_spp"]),
        fit.TARGET_FRAME, 1)
    start_objs = fit.draw_materials(objects, SEED, 2)
    sc, cam, rst = common.reference(cell, start_objs, cam_spec, start_image,
                                    st, dev)
    got = ref.fit_steps(sc, cam, rst, target, common.lane_block(st), steps,
                        cell.traffic["lr"])
    mips = ref.mip_keys(len(sc.env_mips))
    scene = port.scene(start_objs, start_image, common.env_mips(cell), dev)
    prog = {"losses": []}

    def callback(i, params, loss):
        p = dict(params["material_params"],
                 **dict(zip(mips, params["env_mips"])))
        prog["losses"].append(loss)
        if i == 0:
            prog["grads"] = {k: torch.zeros_like(v) if v.grad is None
                             else v.grad.clone() for k, v in p.items()}
        prog["params"] = {k: v.detach().clone() for k, v in p.items()}

    fit_materials(scene, port.camera(cam_spec, st["width"] / st["height"],
                                     dev), port.settings(st), target,
                  steps=steps, lr=cell.traffic["lr"], optimize_env=True,
                  callback=callback)
    start = ref.start_params(sc)
    gaps = fit.fit_gaps(prog, got, start)
    assert len(prog["losses"]) == steps
    assert gaps["loss_gap"] <= 1e-6, gaps
    assert gaps["grad_gap"] <= 1e-4 and gaps["change_gap"] <= 1e-4, gaps
    read = [k for k in mips if fit._norm(got["grads"][k]) > 0.0]
    assert read and "mip0" not in read  # the lookup starts at mip 1
    assert fit_sky.sky_grad_gap(prog["grads"], got["grads"], mips) <= 1e-4
    for k in start:
        assert fit._norm(prog["grads"][k] - got["grads"][k]) <= \
            1e-4 * fit._norm(got["grads"][k]) + 1e-9, k
    moved = fit.fit_gaps(dict(prog, params=start), got, start)
    assert moved["change_gap"] > cell.traffic["check"]["limits"][
        "change_gap"], moved


def test_the_control_and_the_faults_are_not_correct():
    cell = tiny_cell()
    limits = cell.traffic["check"]["limits"]
    got = dict(control_fit_sky.readings(cell, SEED + 2, torch.device("cpu")))
    assert set(got) == set(control_fit_sky.FAULTS)
    for mode, values in got.items():
        assert _past(values, limits), (mode, values)
    # a mirrored gradient keeps every norm: the norms' gap cannot see it,
    # the texel by texel gap does
    assert "sky_grad_gap" in _past(got["sky_mirrored"], limits), got
    assert got["sky_mirrored"]["grad_gap"] <= 1e-6
    assert got["mip_dropped"]["sky_grad_gap"] == pytest.approx(1.0)


def _mirror_the_sky_gradient(opt, args, kwargs):
    # a planted fault in the timed path: every mip's gradient (a leaf of
    # [H, W, 3]) mirrored in u before the optimizer's update
    for group in opt.param_groups:
        for p in group["params"]:
            if p.dim() == 3 and p.grad is not None:
                p.grad = p.grad.flip(1)


def _half_batch(monkeypatch):
    # a planted fault in the timed path: the loss's mean over every other
    # pixel row
    import halogen_tpu_torch.diff.grad as grad

    def half(params, scene, camera, settings, target, frame=0):
        img = grad.render_with_params(params, scene, camera, settings, frame)
        t = torch.as_tensor(target, dtype=img.dtype, device=img.device)
        return torch.mean((img[::2] - t[::2]) ** 2)

    monkeypatch.setattr(grad, "render_loss", half)


@pytest.mark.parametrize("fault", ["none", "sky_mirrored", "half_batch"])
def test_a_run_is_correct_unless_its_timed_path_is_broken(monkeypatch,
                                                          fault):
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    cell = tiny_cell()
    hook = (register_optimizer_step_pre_hook(_mirror_the_sky_gradient)
            if fault == "sky_mirrored" else None)
    if fault == "half_batch":
        _half_batch(monkeypatch)
    try:
        out = cell.entry().run(cell, seed=SEED + 4, seconds=0.2, trace=False,
                               t0=time.perf_counter(),
                               device=torch.device("cpu"))
    finally:
        if hook is not None:
            hook.remove()
    checks = out["checks"]
    assert out["correct"] is (fault == "none"), checks
    past = [k for k, v in checks.items() if v["value"] > v["limit"]]
    if fault == "sky_mirrored":  # the norms' gaps cannot see it
        assert "sky_grad_gap" in past and "grad_gap" not in past, checks
    if fault == "half_batch":  # the step's loss is not its image's
        assert "image_loss_gap" in past, checks


def _trace(kind: str, **extra) -> dict:
    return dict({"kind": kind, "busy_s": 0.4, "wall_s": 0.5, "steps": 5,
                 "launches": 900, "work": {"least_s": 0.001}}, **extra)


READERS = ("sky_backward.fit", "sky_roofline.fit", "sky_atlas_builds.fit")


@pytest.mark.parametrize("name", READERS)
def test_the_sky_readers_read_only_a_sky_fit_trace(name):
    read = harness.reader(ROOT, name)
    sky = dict(sky_backward_s=0.1, sky_least_s=0.002, sky_atlas_builds=32.0)
    assert read(_trace("frame")) is None
    assert read(_trace("frame", **sky)) is None
    assert read(_trace("fit")) is None  # cornell_fit's trace
    # a program without the atlas counter: that reader alone reads nothing
    no_counter = read(_trace("fit", **dict(sky, sky_atlas_builds=None)))
    assert (no_counter is None) is (name == "sky_atlas_builds.fit")
    assert read(_trace("fit", **sky)) == pytest.approx(
        {"sky_backward.fit": 25.0, "sky_roofline.fit": 2.0,
         "sky_atlas_builds.fit": 32.0}[name])
