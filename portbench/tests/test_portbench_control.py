"""The comparison that decides `correct` has to fail where it should: the
control (the reference in bfloat16, `control.py`) reads past each cell's
limits, and a run whose timed path is broken underneath (a step that
leaves its state unchanged, half of the batch left out, an answer
altered where it is produced) comes out not correct, while the same run
unbroken comes out correct. At tiny sizes on the CPU, where the port runs
its plain route; the harness's look for a card is skipped."""

import copy
import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import control, harness  # noqa: E402

TINY = {
    "testing_progressive": {"settings": {"width": 8, "height": 4},
                            "pixels": 16, "env": 64},
    "cornell_frames": {"settings": {"width": 16, "height": 16,
                                    "samples_per_pixel": 8}, "pixels": 64},
    "cornell_fit": {"settings": {"width": 12, "height": 12,
                                 "samples_per_pixel": 4}, "target_spp": 2},
}


def tiny_cell(name: str):
    cell = harness.find_cell(ROOT, name)
    cell.traffic = copy.deepcopy(cell.traffic)
    t = TINY[name]
    cell.traffic.setdefault("settings", {}).update(t["settings"])
    if "pixels" in t:
        cell.traffic["check"]["pixels"] = t["pixels"]
    if "target_spp" in t:
        cell.traffic["target_spp"] = t["target_spp"]
    if "env" in t:
        cell.config = dict(cell.config, envmap=dict(cell.config["envmap"],
                                                    width=t["env"]))
    return cell


def _run(cell, seed=4000000007):
    return cell.entry().run(cell, seed=seed, seconds=0.2, trace=False,
                            t0=time.perf_counter(),
                            device=torch.device("cpu"))


def _past(readings: dict, limits: dict) -> bool:
    return any(readings[k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", ["cornell_frames", "testing_progressive"])
def test_the_control_fails_a_frames_cell(name):
    cell = tiny_cell(name)
    got = control.frames_readings(cell, 4000000011, 8, torch.device("cpu"))
    assert _past(got["lowp"], cell.traffic["check"]["limits"]), got


@pytest.mark.parametrize("name", ["cornell_frames", "testing_progressive"])
def test_a_fault_on_few_pixels_is_not_correct(name):
    # 5% of the pixels 5% off: within what the 90th percentile and the
    # share past 1e-3 let by, past the cell's limits all the same
    from portbench.entries import frames

    limits = harness.find_cell(ROOT, name).traffic["check"]["limits"]
    ref = torch.rand(512, 3, generator=torch.Generator().manual_seed(3)) + 0.1
    got = ref.clone()
    got[:26] *= 1.05
    gaps = frames.frame_gaps(got, ref)
    assert gaps["pixel_gap_q90"] <= limits["pixel_gap_q90"]
    assert gaps["pixels_apart"] <= limits["pixels_apart"]
    assert harness.judge(gaps, limits)[1] is False


def test_the_control_and_the_half_batch_fail_the_fit_cell():
    cell = tiny_cell("cornell_fit")
    got = control.fit_readings(cell, 4000000013, torch.device("cpu"))
    limits = cell.traffic["check"]["limits"]
    assert _past(got["lowp"], limits), got
    assert _past(got["half_batch"], limits), got


def test_the_reference_follows_the_fit_from_the_start():
    # a run compares the window's last step, taken by the reference from
    # the program's state; here the reference takes every step from the
    # start instead, as the program does
    from halogen_tpu_torch.diff.grad import fit_materials

    from portbench import common, port
    from portbench.entries import fit
    from portbench.reference import fit as ref_fit
    from portbench.reference import tracer as ref_tracer

    cell, seed, steps, dev = tiny_cell("cornell_fit"), 4000000017, 4, "cpu"
    st = common.settings(cell)
    objects, cam_spec, image = common.inputs(cell, seed, dev)
    target_objs = fit.draw_materials(objects, seed, 1)
    start_objs = fit.draw_materials(objects, seed, 2)
    rsc, rcam, rst = common.reference(cell, target_objs, cam_spec, image, st,
                                      dev)
    target = ref_tracer.render_image(
        rsc, rcam, dict(rst, samples_per_pixel=cell.traffic["target_spp"]),
        fit.TARGET_FRAME, 1)
    sc, cam, rst = common.reference(cell, start_objs, cam_spec, image, st,
                                    dev)
    ref = ref_fit.fit_steps(sc, cam, rst, target, common.lane_block(st),
                            steps, cell.traffic["lr"])
    scene = port.scene(start_objs, image, common.env_mips(cell), dev)
    prog = {"losses": []}

    def callback(i, params, loss):
        mp = params["material_params"]
        prog["losses"].append(loss)
        if i == 0:
            prog["grads"] = {k: v.grad.clone() for k, v in mp.items()}
        prog["params"] = {k: v.detach().clone() for k, v in mp.items()}

    fit_materials(scene, port.camera(cam_spec, st["width"] / st["height"],
                                     dev), port.settings(st), target,
                  steps=steps, lr=cell.traffic["lr"], callback=callback)
    start = {k: sc.materials[k] for k in ref["grads"]}
    gaps = fit.fit_gaps(prog, ref, start)
    limits = cell.traffic["check"]["limits"]
    assert len(prog["losses"]) == steps
    assert all(gaps[k] <= limits[k] for k in gaps), gaps
    moved = fit.fit_gaps(dict(prog, params=start), ref, start)
    assert moved["change_gap"] > limits["change_gap"], moved


def _frame_fault(monkeypatch, fault):
    import halogen_tpu_torch.render.accumulate as acc

    render = acc.render_frame
    if fault == "unchanged":  # renders, but keeps the state it was given
        monkeypatch.setattr(acc, "accumulate_step",
                            lambda state, scene, camera, settings: (
                                render(scene, camera, settings, 1), state)[1])
    elif fault == "half_batch":
        monkeypatch.setattr(acc, "render_frame", lambda sc, cam, st, f: render(
            sc, cam, st.replace(samples_per_pixel=max(
                1, st.samples_per_pixel // 2)), f) if st.samples_per_pixel > 1
            else render(sc, cam, st, f)[:, ::2].repeat_interleave(2, dim=1))
    elif fault == "altered":
        monkeypatch.setattr(acc, "render_frame",
                            lambda sc, cam, st, f: render(sc, cam, st, f)
                            * 1.01)


def _fit_fault(monkeypatch, fault):
    import halogen_tpu_torch.diff.grad as grad

    loss_fn = grad.render_loss
    if fault == "unchanged":  # Adam's update leaves its state as it was
        from torch.optim import adam

        monkeypatch.setattr(adam, "adam", lambda *a, **k: None)
    elif fault == "half_batch":
        def half(params, scene, camera, settings, target, frame=0):
            img = grad.render_with_params(params, scene, camera, settings,
                                          frame)
            t = torch.as_tensor(target, dtype=img.dtype, device=img.device)
            return torch.mean((img[::2] - t[::2]) ** 2)
        monkeypatch.setattr(grad, "render_loss", half)
    elif fault == "altered":
        monkeypatch.setattr(grad, "render_loss",
                            lambda *a, **k: loss_fn(*a, **k) * 1.01)


CASES = [(n, f) for n in ("cornell_frames", "testing_progressive",
                          "cornell_fit")
         for f in ("none", "unchanged", "half_batch", "altered")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    cell = tiny_cell(name)
    if fault != "none":
        (_fit_fault if name == "cornell_fit" else _frame_fault)(
            monkeypatch, fault)
    out = _run(cell)
    assert out["correct"] is (fault == "none"), out["checks"]
