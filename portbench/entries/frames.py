"""Entry `frames`: a viewer's progressive render. One client calls
`Renderer.step()` back to back, each call one frame of the cell's
`samples_per_pixel` folded into the running mean and the image copied to
the host, as a viewport shows it.

Correct: at pixels drawn from the seed, the image the viewer holds after
the window's last frame against the plain reference's progressive mean of
the same frames, samples and blend (`reference/tracer.py`).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import common, harness
from portbench.reference import tracer as ref_tracer


def frame_gaps(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Per pixel the largest channel gap over the reference's largest
    channel (+ 0.01): its 90th percentile, its largest, and the shares of
    pixels past 1e-3 (apart) and past 1e-2 (far). A traffic's limits pick
    which of them its cell compares."""
    gap = ((got - ref).abs().amax(dim=1)
           / (ref.abs().amax(dim=1) + 1e-2)).cpu().tolist()
    return {"pixel_gap_q90": harness.quantile(gap, 0.9),
            "pixel_gap_max": max(gap),
            "pixels_apart": sum(g > 1e-3 for g in gap) / len(gap),
            "pixels_far": sum(g > 1e-2 for g in gap) / len(gap)}


def reference_means(sc, cam, rst, pix, n_frames: int, block: int,
                    lowp: bool = False) -> torch.Tensor:
    """[K, 3] progressive mean at flat pixels `pix` after frames 1..N."""
    spp = rst["samples_per_pixel"]
    dev = pix.device
    k = pix.shape[0]
    shape = (n_frames, k, spp)
    f = torch.arange(1, n_frames + 1, device=dev)[:, None, None].expand(shape)
    p = pix[None, :, None].expand(shape)
    lane = torch.arange(spp, device=dev)[None, None, :].expand(shape)
    with torch.no_grad():
        col = ref_tracer.sample_colors(sc, cam, rst, p.reshape(-1),
                                       f.reshape(-1), lane.reshape(-1),
                                       lowp=lowp)
        frames = ref_tracer.frame_values(col.reshape(-1, spp, 3), spp, block)
        return ref_tracer.accumulate(frames.reshape(n_frames, k, 3))


def check_pixels(cell, seed: int, width: int, height: int, device):
    k = int(cell.traffic["check"]["pixels"])
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(width * height, generator=gen)[:k].to(device)


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device):
    from halogen_tpu_torch.render.accumulate import Renderer

    from portbench import port

    t_entry = time.perf_counter()
    st = common.settings(cell)
    w, h, spp = st["width"], st["height"], st["samples_per_pixel"]
    objects, cam_spec, image = common.inputs(cell, seed, device)
    scene = port.scene(objects, image, common.env_mips(cell), device)
    t_scene = time.perf_counter()
    renderer = Renderer(scene, port.camera(cam_spec, w / h, device),
                        port.settings(st))
    renderer.step()  # builds and warms every kernel this cell launches
    renderer.reset()
    if trace and device.type == "cuda":
        harness.warm_profiler(device)
    setup_s = time.perf_counter() - t0

    held = {}

    def step():
        held["image"] = renderer.step()

    trace_steps = int(cell.traffic.get("trace_steps", 10)) if trace else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    win = harness.Window(seconds, trace_steps)
    win.run(step)
    ws = harness.window_stats(win.spans, win.start)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n = ws["steps"]
    print(f"set-up {setup_s:.4f} s: before the entry {t_entry - t0:.4f} s,"
          f" scene {t_scene - t_entry:.4f} s", file=sys.stderr)
    print(f"frames {n} in {ws['seconds']:.4f} s; median "
          f"{ws['median_s'] * 1e3:.4f} ms, p95 {ws['p95_s'] * 1e3:.4f} ms",
          file=sys.stderr)
    harness.print_stretches(win)
    image_got = torch.from_numpy(np.ascontiguousarray(held["image"]))
    block = common.lane_block(st)
    traced = None
    if trace:
        traced = harness.reduce_trace(win.prof, win.traced[1] - win.traced[0],
                                      trace_steps)
    del renderer, scene, held
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    sc, cam, rst = common.reference(cell, objects, cam_spec, image, st,
                                    device)
    pix = check_pixels(cell, seed, w, h, device)
    ref = reference_means(sc, cam, rst, pix, n, block)
    got = image_got.reshape(-1, 3)[pix.cpu()].to(device)
    print(f"reference check {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    gaps = frame_gaps(got, ref)
    print(f"readings {gaps}", file=sys.stderr)
    checks, ok = harness.judge(gaps, cell.traffic["check"]["limits"])
    out = {"correct": ok, "attempted": n, "failed": 0, "checks": checks,
           "device": common.device_record(device, peak),
           "e2e": {"frame_mrays": n * w * h * spp / ws["seconds"] / 1e6,
                   "frame_p95_ms": ws["p95_s"] * 1e3, "setup_s": setup_s}}
    if trace:
        gen = torch.Generator().manual_seed(seed + 1)
        s = int(cell.traffic.get("work_samples", 1 << 16))
        pixels = torch.randint(w * h, (s,), generator=gen).to(device)
        frames = torch.randint(1, trace_steps + 1, (s,),
                               generator=gen).to(device)
        lanes = torch.randint(spp, (s,), generator=gen).to(device)
        traced["kind"] = "frame"
        traced["work"] = common.traced_work(
            sc, cam, rst, pixels, frames, lanes, trace_steps * w * h * spp,
            w * h * 3 * 4, trace_steps, backward=False)
        out["trace"] = traced
    return out
