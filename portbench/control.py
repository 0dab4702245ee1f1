"""The readings that a cell's limits are set between, on the chip at the
cell's own size:

    python3 portbench/control.py --workload <name> --seeds 1 2 3 [--frames N]

For each seed it puts the plain reference in the program's place, once in
float32 and once as the control (`lowp`: its per-ray state in bfloat16,
the precision below the float32 the configurations state), and prints
the numbers a run compares, of the control against the float32
reference: the upper readings, with the verdict of the cell's limits on
them (`harness.judge`, as a run judges). A `fit` cell's control takes
the second step from the reference's state after the first, as a run
follows the window's last step from the program's, and reads the fault
"half of the batch left out" there too (the loss's mean over every
other pixel row). `--frames` is the count of frames a
`frames` cell's window completes. One JSON line a seed and mode.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def frames_readings(cell, seed: int, n_frames: int, device) -> dict:
    import torch

    from portbench import common
    from portbench.entries import frames

    st = common.settings(cell)
    objects, cam_spec, image = common.inputs(cell, seed, device)
    sc, cam, rst = common.reference(cell, objects, cam_spec, image, st,
                                    device)
    w, h = st["width"], st["height"]
    block = common.lane_block(st)
    pix = frames.check_pixels(cell, seed, w, h, device)
    ref = frames.reference_means(sc, cam, rst, pix, n_frames, block)
    low = frames.reference_means(sc, cam, rst, pix, n_frames, block,
                                 lowp=True)
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    return {"lowp": frames.frame_gaps(low, ref)}


def fit_readings(cell, seed: int, device) -> dict:
    from portbench import common
    from portbench.entries import fit
    from portbench.reference import fit as ref_fit
    from portbench.reference import tracer as ref_tracer

    st = common.settings(cell)
    objects, cam_spec, image = common.inputs(cell, seed, device)
    target_objs = fit.draw_materials(objects, seed, 1)
    start_objs = fit.draw_materials(objects, seed, 2)
    rsc, rcam, rst = common.reference(cell, target_objs, cam_spec, image, st,
                                      device)
    tst = dict(rst, samples_per_pixel=int(cell.traffic["target_spp"]))
    import torch

    with torch.no_grad():
        target = ref_tracer.render_image(rsc, rcam, tst, fit.TARGET_FRAME, 1)
    sc, cam, rst = common.reference(cell, start_objs, cam_spec, image, st,
                                    device)
    block = common.lane_block(st)
    lr = float(cell.traffic.get("lr", 5e-2))
    first = ref_fit.fit_steps(sc, cam, rst, target, block, 1, lr)
    state = (sc, cam, rst, target, block, 1, first["params"], first["adam"],
             lr)
    ref = ref_fit.follow_step(*state)
    exact = {"start_gap": 0.0, "adam_steps_gap": 0.0}  # the reference's own
    low = ref_fit.follow_step(*state, lowp=True)
    half = ref_fit.follow_step(*state, rows=slice(0, None, 2))
    return {"lowp": dict(fit.fit_gaps(low, ref, first["params"]), **exact),
            "half_batch": dict(fit.fit_gaps(half, ref, first["params"]),
                               **exact)}


def main(argv=None) -> int:
    import torch

    from portbench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.find_cell(ROOT, args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        if cell.traffic["entry"] == "frames":
            got = frames_readings(cell, seed, args.frames, device)
        else:
            got = fit_readings(cell, seed, device)
        for mode, values in got.items():
            _, ok = harness.judge(values, cell.traffic["check"]["limits"])
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "readings": values,
                              "correct": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
