"""Entry `fit`: inverse rendering of materials. One fitting script runs
`fit_materials` (Adam, projection onto the physical ranges; step i renders
frame i) toward a target image; every step waits for its loss.

Set-up builds the port's scene with the fit's start materials drawn from
the seed, renders the target (other materials drawn from the seed) with
the plain reference, its seconds left out of `setup_s`, and runs the
fit's first three steps; the window is the same `fit_materials` call
going on. When the window's time is up, one more step closes it and
counts in it: the window's last step.

Correct: the reference takes that last step from the program's state just
before it (the materials, Adam's moments and step count, read by an
optimizer step pre-hook) at the same frame (`reference/fit.py`
`follow_step`): its loss, the gradient of each material field as the
optimizer got it, and each field's change by the step, each compared by
its norm; Adam's step count against the steps taken; and the program's
start table against the reference's, exactly. The reference follows the
steps in between from the start at a tiny size on the CPU
(`tests/test_portbench_control.py`): at 256 spp one reference step takes
about 30 s on the card.
"""

from __future__ import annotations

import copy
import statistics
import sys
import time

import numpy as np
import torch

from portbench import common, harness
from portbench.reference import fit as ref_fit
from portbench.reference import scene as ref_scene
from portbench.reference import tracer as ref_tracer

SETUP_STEPS = 3  # set-up's steps: the first imports torch._dynamo
TARGET_FRAME = 1 << 20  # the target's samples, apart from every step's


class _WindowClosed(Exception):
    pass


def draw_materials(objects: list, seed: int, salt: int) -> list:
    """The objects with each distinct material's colour (its specular
    colour too where it is metallic) drawn from `seed`; emitters keep
    theirs."""
    gen = np.random.default_rng([seed, salt])
    out, drawn = [], []
    for o in objects:
        for m0, m1 in drawn:
            if m0 == o["material"]:
                break
        else:
            m0, m1 = o["material"], copy.deepcopy(o["material"])
            if m1["emission_intensity"] == 0.0:
                m1["color"] = [float(x) for x in gen.uniform(0.05, 0.95, 3)]
                if m1["metallic"] > 0.0:
                    m1["specular_color"] = [float(x) for x in
                                            gen.uniform(0.05, 0.95, 3)]
            drawn.append((m0, m1))
        out.append(dict(o, material=m1))
    return out


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _leaf_gap(got: dict, ref: dict, keep: list) -> float:
    """Worst gap of norms over the leaves `keep`, each against the larger
    of its reference norm and the median leaf's."""
    ref_n = {k: _norm(ref[k]) for k in keep}
    med = statistics.median(ref_n.values())
    return max(abs(_norm(got[k]) - ref_n[k]) / max(ref_n[k], med)
               for k in keep)


def fit_gaps(prog: dict, ref: dict, start: dict) -> dict:
    """The loss's, the gradient's and the change's gap of a step taken by
    both sides from the parameters `start`. Leaves whose reference
    gradient is under a thousandth of the median nonzero leaf's (the
    fields no path reaches, exactly zero) are left out of the gradient
    and change."""
    g_ref = {k: _norm(v) for k, v in ref["grads"].items()}
    nonzero = [v for v in g_ref.values() if v > 0.0]
    med = statistics.median(nonzero) if nonzero else 0.0
    keep = sorted(k for k, v in g_ref.items() if v >= 1e-3 * med and v > 0)
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    d_prog = {k: prog["params"][k] - start[k] for k in keep}
    d_ref = {k: ref["params"][k] - start[k] for k in keep}
    return {"loss_gap": loss,
            "grad_gap": _leaf_gap(prog["grads"], ref["grads"], keep),
            "change_gap": _leaf_gap(d_prog, d_ref, keep)}


def _table_gap(got: dict, ref: dict) -> float:
    return max(float((got[k].double() - ref[k].double()).abs().max())
               for k in ref_scene.MATERIAL_KEYS)


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device):
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from halogen_tpu_torch.diff.grad import fit_materials

    from portbench import port

    t_entry = time.perf_counter()
    st = common.settings(cell)
    w, h, spp = st["width"], st["height"], st["samples_per_pixel"]
    objects, cam_spec, image = common.inputs(cell, seed, device)
    target_objs = draw_materials(objects, seed, 1)
    start_objs = draw_materials(objects, seed, 2)
    lr = float(cell.traffic.get("lr", 5e-2))

    scene = port.scene(start_objs, image, common.env_mips(cell), device)
    start = {k: getattr(scene.materials, k).detach().clone()
             for k in ref_scene.MATERIAL_KEYS}
    t_scene = time.perf_counter()
    # the target: the reference's render of the target materials, the
    # benchmark's input and not the program's set-up
    rsc, rcam, rst = common.reference(cell, target_objs, cam_spec, image, st,
                                      device)
    tst = dict(rst, samples_per_pixel=int(cell.traffic["target_spp"]))
    with torch.no_grad():
        target = ref_tracer.render_image(rsc, rcam, tst, TARGET_FRAME, 1)
    del rsc
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    target_s = time.perf_counter() - t_scene

    trace_steps = int(cell.traffic.get("trace_steps", 5)) if trace else 0
    win = harness.Window(seconds, trace_steps)
    marks, last = {}, {}

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
        mp = params["material_params"]
        if i < SETUP_STEPS:
            if i == SETUP_STEPS - 1:
                if trace and device.type == "cuda":
                    harness.warm_profiler(device)
                marks["setup_s"] = time.perf_counter() - t0 - target_s
                marks["steps_s"] = time.perf_counter() - t_scene - target_s
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                win.begin()
            return
        if "hook" in marks:  # the closing step
            win.stepped()
            last.update(step=i, loss=loss, after={
                k: v.detach().clone() for k, v in mp.items()})
            raise _WindowClosed
        if not win.stepped():
            last["mp"] = mp
            marks["hook"] = register_optimizer_step_pre_hook(before_last)

    try:
        fit_materials(scene, port.camera(cam_spec, w / h, device),
                      port.settings(st), target, steps=1 << 30, lr=lr,
                      callback=callback)
    except _WindowClosed:
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
    traced = None
    if trace:
        traced = harness.reduce_trace(win.prof, win.traced[1] - win.traced[0],
                                      trace_steps)
    del scene
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    sc, cam, rst = common.reference(cell, start_objs, cam_spec, image, st,
                                    device)
    block = common.lane_block(st)
    values = {"start_gap": _table_gap(start, sc.materials)}
    if "adam" in last and "after" in last:
        ref = ref_fit.follow_step(sc, cam, rst, target, block, last["step"],
                                  last["before"], last["adam"], lr)
        prog = {"losses": [last["loss"]], "grads": last["grads"],
                "params": last["after"]}
        values.update(fit_gaps(prog, ref, last["before"]))
        values["adam_steps_gap"] = abs(last["adam"]["t"] - last["step"])
        print("gradient norms, program; reference: " + ", ".join(
            f"{k} {_norm(last['grads'][k]):.6g}; {_norm(ref['grads'][k]):.6g}"
            for k in ref["grads"]), file=sys.stderr)
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
        traced["kind"] = "fit"
        traced["work"] = common.traced_work(
            sc, cam, rst, pixels, frames, lanes, trace_steps * w * h * spp,
            w * h * 3 * 4 + grad_bytes, trace_steps, backward=True)
        out["trace"] = traced
    return out
