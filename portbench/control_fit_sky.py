"""The readings that a `fit_sky` cell's limits are set between, on the chip
at the cell's own size:

    python3 portbench/control_fit_sky.py --workload testing_fit --seeds 1 2 3

For each seed the plain reference takes the fit's first step from the
start, as a run follows the window's last step from the program's state;
against that step (taken at the cotangent of the image in the program's
place, as a run takes it) it reads the control and three faults, each put
in the program's place, as a run reads the program (`fit.fit_gaps`,
`fit_sky.sky_grad_gap`, the image's loss against the step's):

- `sky_mirrored`: every mip's gradient mirrored in u (the same norms);
- `mip_dropped`: the gradient of the mip with the largest one dropped
  (zero);
- `half_batch`: the loss's mean over every other pixel row;
- `lowp`: the reference in bfloat16 (its per-ray state rounded at the
  camera and after every bounce, the precision below the float32 the
  configuration states).

One JSON line a seed and mode, with the verdict of the cell's limits
(`harness.judge`, as a run judges) and the seconds the reference's step
took.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FAULTS = ("sky_mirrored", "mip_dropped", "half_batch", "lowp")
EXACT = {"start_gap": 0.0, "sky_start_gap": 0.0, "adam_steps_gap": 0.0}


def readings(cell, seed: int, device, faults=FAULTS):
    """(mode, the numbers a run compares, and the seconds of the
    reference's sound step) of each of `faults`, one at a time."""
    import torch

    from portbench import common
    from portbench.entries import fit, fit_sky
    from portbench.reference import fit_sky as ref
    from portbench.reference import tracer as ref_tracer
    from portbench.scenes import build

    st = common.settings(cell)
    objects, cam_spec, image = common.inputs(cell, seed, device)
    start_image = build.procedural_hdri(cell.config["envmap"]["width"],
                                        seed + 1, device)
    rsc, rcam, rst = common.reference(cell, fit.draw_materials(objects, seed,
                                                               1),
                                      cam_spec, image, st, device)
    tst = dict(rst, samples_per_pixel=int(cell.traffic["target_spp"]))
    with torch.no_grad():
        target = ref_tracer.render_image(rsc, rcam, tst, fit.TARGET_FRAME, 1)
    del rsc
    sc, cam, rst = common.reference(cell, fit.draw_materials(objects, seed, 2),
                                    cam_spec, start_image, st, device)
    block = common.lane_block(st)
    lr = float(cell.traffic.get("lr", 5e-2))
    start = ref.start_params(sc)
    zeros = {k: torch.zeros_like(v) for k, v in start.items()}
    adam = {"m": zeros, "v": zeros, "t": 0}
    state = (sc, cam, rst, target, block, 0, start, adam, lr)
    mips = ref.mip_keys(len(sc.env_mips))
    t = time.perf_counter()
    sound = ref.follow_step_sky(*state)
    seconds = time.perf_counter() - t

    def gaps(got: dict, follow: dict) -> dict:
        return dict(fit.fit_gaps(got, follow, start), **EXACT,
                    sky_grad_gap=fit_sky.sky_grad_gap(
                        got["grads"], follow["grads"], mips),
                    image_loss_gap=abs(float(torch.mean(
                        (got["image"] - target) ** 2)) - got["losses"][0])
                    / abs(got["losses"][0]))

    def with_grads(grads: dict) -> dict:
        return {"losses": sound["losses"], "grads": grads,
                "params": ref.adam_step(start, adam, grads, lr),
                "image": sound["image"]}

    for mode in faults:
        follow = sound
        if mode == "lowp":
            got = ref.follow_step_sky(*state, lowp=True)
            # a run follows the gradient at the program's image: here the
            # bfloat16 reference's
            follow = ref.follow_step_sky(*state, image=got["image"])
        elif mode == "half_batch":
            got = ref.follow_step_sky(*state, rows=slice(0, None, 2))
        elif mode == "sky_mirrored":
            got = with_grads({k: g.flip(1) if k in mips else g
                              for k, g in sound["grads"].items()})
        elif mode == "mip_dropped":
            top = max(mips, key=lambda k: fit._norm(sound["grads"][k]))
            got = with_grads({k: torch.zeros_like(g) if k == top else g
                              for k, g in sound["grads"].items()})
        yield mode, dict(gaps(got, follow), reference_s=seconds)


def main(argv=None) -> int:
    import torch

    from portbench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.find_cell(ROOT, args.workload)
    limits = cell.traffic["check"]["limits"]
    for seed in args.seeds:
        for mode, values in readings(cell, seed, torch.device(args.device)):
            _, ok = harness.judge(
                {k: v for k, v in values.items() if k in limits}, limits)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "readings": values,
                              "correct": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
