"""Entry `fit_sky`: inverse rendering of the materials and the sky. One
fitting script runs `fit_materials(optimize_env=True)` (Adam over the
float material fields and every mip of the sky, each mip its own leaf;
the materials projected onto their physical ranges, the texels onto >= 0;
step i renders frame i) toward a target image; every step waits for its
loss.

Set-up builds the port's scene with the start materials drawn from the
seed (`fit.draw_materials`, salt 2) under the sky of seed + 1
(`build.procedural_hdri`), renders the target with the plain reference
(the materials of salt 1 under the sky of the seed; its seconds left out
of `setup_s`), and runs the fit's first three steps; the window is the
same `fit_materials` call going on, closed by one more step, as `fit.py`
closes its window.

Correct: the reference takes that last step from the program's state just
before it (materials, mips, their gradients as the optimizer got them and
Adam's moments and step count, read by an optimizer step pre-hook) at the
same frame (`reference/fit_sky.py` `follow_step_sky`), its gradient at the
cotangent of the program's image of that step (rendered again from that
state; `image_loss_gap`, its loss against the step's, holds it to the
step's own), its loss its own: `fit.fit_gaps` over
the material fields and the mips (the loss, and each leaf's gradient and
change by its norm); `sky_grad_gap`, over the mips whose reference
gradient is not zero, the largest norm of the texel-by-texel difference
of the gradients over the reference's (at least the median mip's), which
sees a tap landing on another texel where norms do not; Adam's step count against the steps
taken; and the program's start table and start mips against the
reference's, exactly.

A traced run also reports the sky backward's device time (its taps, radix
ordering and per-texel sums kernels), its least time (`work_sky.py`) and
the atlases built a step (the program's counter `sky.atlas_builds`, where
the program has it).
"""

from __future__ import annotations

import re
import statistics
import sys
import time

import torch

from portbench import common, harness, work_sky
from portbench.entries import fit
from portbench.reference import fit_sky as ref_fit_sky
from portbench.reference import scene as ref_scene
from portbench.reference import tracer as ref_tracer
from portbench.scenes import build

SETUP_STEPS = fit.SETUP_STEPS
# the sky backward's kernels in the profiler's rows: the taps, the radix
# ordering's passes and the per-texel sums
SKY_BACKWARD_KERNELS = re.compile(
    r"^(sky_backward_taps|sky_radix_\w+|sky_reduce_texels)\b")
ATLAS_COUNTER = "sky.atlas_builds"


def sky_grad_gap(got: dict, ref: dict, keys) -> float:
    """Over the leaves `keys` whose reference gradient is not zero, the
    largest norm of the texel-by-texel difference of the gradients,
    |g_got - g_ref|, over the larger of |g_ref| and the median of those
    leaves' |g_ref| (as `fit.fit_gaps` bounds a leaf's gap: a mip that a
    handful of paths read, its norm a millionth of the others', would
    read a whole gap where one of them parts); 0 where every reference
    gradient is zero."""
    norms = {k: fit._norm(ref[k]) for k in keys}
    read = [k for k in keys if norms[k] > 0.0]
    if not read:
        return 0.0
    med = statistics.median(norms[k] for k in read)
    return max(fit._norm(got[k] - ref[k]) / max(norms[k], med) for k in read)


def sky_backward_s(prof) -> float:
    """Device seconds of the sky backward's kernels in a profile."""
    return sum(harness._device_us(r) for r in prof.key_averages()
               if SKY_BACKWARD_KERNELS.match(harness._short(r.key))) / 1e6


def _atlas_builds():
    """The program's count of atlases built, None where it has no such
    counter."""
    from halogen_tpu_torch.utils import profiling

    return profiling.counts().get(ATLAS_COUNTER)


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device):
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from halogen_tpu_torch.diff.grad import (
        fit_materials,
        render_with_params,
        with_material_params,
    )

    from portbench import port

    t_entry = time.perf_counter()
    st = common.settings(cell)
    w, h, spp = st["width"], st["height"], st["samples_per_pixel"]
    objects, cam_spec, image = common.inputs(cell, seed, device)
    start_image = build.procedural_hdri(cell.config["envmap"]["width"],
                                        seed + 1, device)
    target_objs = fit.draw_materials(objects, seed, 1)
    start_objs = fit.draw_materials(objects, seed, 2)
    lr = float(cell.traffic.get("lr", 5e-2))
    n_mips = common.env_mips(cell)
    mips = ref_fit_sky.mip_keys(n_mips)

    scene = port.scene(start_objs, start_image, n_mips, device)
    start = {k: getattr(scene.materials, k).detach().clone()
             for k in ref_scene.MATERIAL_KEYS}
    start_mips = [m.detach().clone() for m in scene.env_mips]
    t_scene = time.perf_counter()
    # the target: the reference's render of the target materials under
    # the target sky, the benchmark's input and not the program's set-up
    rsc, rcam, rst = common.reference(cell, target_objs, cam_spec, image, st,
                                      device)
    tst = dict(rst, samples_per_pixel=int(cell.traffic["target_spp"]))
    with torch.no_grad():
        target = ref_tracer.render_image(rsc, rcam, tst, fit.TARGET_FRAME, 1)
    del rsc, image
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    target_s = time.perf_counter() - t_scene

    trace_steps = int(cell.traffic.get("trace_steps", 5)) if trace else 0
    win = harness.Window(seconds, trace_steps)
    marks, last = {}, {}

    def leaves(params) -> dict:
        return dict(params["material_params"],
                    **dict(zip(mips, params["env_mips"])))

    def before_last(opt, args, kwargs):
        # the program's state as the closing step's Adam update finds it
        mp = last["mp"]
        last["before"] = {k: v.detach().clone() for k, v in mp.items()}
        last["grads"] = {k: (torch.zeros_like(v) if v.grad is None
                             else v.grad.detach().clone())
                         for k, v in mp.items()}
        last["adam"] = {
            "m": {k: opt.state[v]["exp_avg"].detach().clone()
                  if v in opt.state else torch.zeros_like(v)
                  for k, v in mp.items()},
            "v": {k: opt.state[v]["exp_avg_sq"].detach().clone()
                  if v in opt.state else torch.zeros_like(v)
                  for k, v in mp.items()},
            "t": max((int(opt.state[v]["step"]) for v in mp.values()
                      if v in opt.state), default=0)}

    def callback(i, params, loss):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if i < SETUP_STEPS:
            if i == SETUP_STEPS - 1:
                if trace and device.type == "cuda":
                    harness.warm_profiler(device)
                marks["setup_s"] = time.perf_counter() - t0 - target_s
                marks["steps_s"] = time.perf_counter() - t_scene - target_s
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                marks["atlases0"] = _atlas_builds()
                win.begin()
            return
        if "hook" in marks:  # the closing step
            win.stepped()
            last.update(step=i, loss=loss, after={
                k: v.detach().clone() for k, v in leaves(params).items()})
            raise fit._WindowClosed
        more = win.stepped()
        if win.traced is not None and "atlases1" not in marks:
            marks["atlases1"] = _atlas_builds()
        if not more:
            last["mp"] = leaves(params)
            marks["hook"] = register_optimizer_step_pre_hook(before_last)

    camera, settings = port.camera(cam_spec, w / h, device), port.settings(st)
    try:
        fit_materials(scene, camera, settings, target, steps=1 << 30, lr=lr,
                      optimize_env=True, callback=callback)
    except fit._WindowClosed:
        pass
    finally:
        if "hook" in marks:
            marks["hook"].remove()
    ws = harness.window_stats(win.spans, win.start)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n = ws["steps"]
    print(f"set-up {marks['setup_s']:.4f} s: before the entry "
          f"{t_entry - t0:.4f} s, scene {t_scene - t_entry:.4f} s, first "
          f"steps {marks['steps_s']:.4f} s; the target {target_s:.4f} s "
          f"(left out)", file=sys.stderr)
    print(f"steps {n} in {ws['seconds']:.4f} s; median "
          f"{ws['median_s'] * 1e3:.4f} ms, p95 {ws['p95_s'] * 1e3:.4f} ms; "
          f"last step {last.get('step')}, loss {last.get('loss')}",
          file=sys.stderr)
    harness.print_stretches(win)
    image = None
    if "before" in last:
        # the program's image of the closing step, rendered again from the
        # state the step started from (the kernels give the same bits with
        # and without a gradient): the reference follows its cotangent
        b = last["before"]
        with torch.no_grad():
            image = render_with_params(
                {"materials": with_material_params(
                    scene.materials,
                    {k: b[k] for k in ref_scene.MATERIAL_KEYS}),
                 "env_mips": tuple(b[k] for k in mips)},
                scene, camera, settings, last["step"])
    traced = None
    if trace:
        traced = harness.reduce_trace(win.prof, win.traced[1] - win.traced[0],
                                      trace_steps)
        traced["sky_backward_s"] = sky_backward_s(win.prof)
        a0, a1 = marks.get("atlases0"), marks.get("atlases1")
        traced["sky_atlas_builds"] = (None if a0 is None or a1 is None
                                      else (a1 - a0) / trace_steps)
    del scene
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    sc, cam, rst = common.reference(cell, start_objs, cam_spec, start_image,
                                    st, device)
    block = common.lane_block(st)
    values = {"start_gap": fit._table_gap(start, sc.materials),
              "sky_start_gap": max(
                  float((a.double() - b.double()).abs().max())
                  for a, b in zip(start_mips, sc.env_mips))}
    if "adam" in last and "after" in last:
        ref = ref_fit_sky.follow_step_sky(
            sc, cam, rst, target, block, last["step"], last["before"],
            last["adam"], lr, image=image)
        prog = {"losses": [last["loss"]], "grads": last["grads"],
                "params": last["after"]}
        values.update(fit.fit_gaps(prog, ref, last["before"]))
        values["sky_grad_gap"] = sky_grad_gap(last["grads"], ref["grads"],
                                              mips)
        values["adam_steps_gap"] = abs(last["adam"]["t"] - last["step"])
        # the image the reference's cotangent came from is the step's own
        values["image_loss_gap"] = abs(
            float(torch.mean((image - target) ** 2)) - last["loss"]) / abs(
            last["loss"])
        print("gradient norms, program; reference; norm of the difference: "
              + ", ".join(f"{k} {fit._norm(last['grads'][k]):.6g}; "
                          f"{fit._norm(ref['grads'][k]):.6g}; "
                          f"{fit._norm(last['grads'][k] - ref['grads'][k]):.4g}"
                          for k in ref["grads"]), file=sys.stderr)
        del ref
    print(f"reference check {time.perf_counter() - t_ref:.1f} s; "
          f"readings {values}", file=sys.stderr)
    checks, ok = harness.judge(values, cell.traffic["check"]["limits"])
    out = {"correct": ok, "attempted": n, "failed": 0, "checks": checks,
           "device": common.device_record(device, peak),
           "e2e": {"fit_mrays": n * w * h * spp / ws["seconds"] / 1e6,
                   "fit_peak_gib": peak / 2 ** 30, "setup_s":
                   marks["setup_s"]}}
    if trace:
        gen = torch.Generator().manual_seed(seed + 1)
        s = int(cell.traffic.get("work_samples", 1 << 16))
        first = SETUP_STEPS  # the traced stretch's steps render these frames
        pixels = torch.randint(w * h, (s,), generator=gen).to(device)
        frames = torch.randint(first, first + trace_steps, (s,),
                               generator=gen).to(device)
        lanes = torch.randint(spp, (s,), generator=gen).to(device)
        grad_bytes = sum(v.numel() * v.element_size() for v in start.values())
        grad_bytes += sum(m.numel() * m.element_size() for m in start_mips)
        total = trace_steps * w * h * spp
        traced["kind"] = "fit"
        traced["work"] = common.traced_work(
            sc, cam, rst, pixels, frames, lanes, total,
            w * h * 3 * 4 + grad_bytes, trace_steps, backward=True)
        traced["sky_least_s"] = work_sky.traced_sky_work(
            sc, cam, rst, pixels, frames, lanes, total, trace_steps)["least_s"]
        out["trace"] = traced
    return out
