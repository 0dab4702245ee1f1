"""Where the time of one main-path frame goes, on one CUDA device.

Run from the root of a checkout:

    python3 -m halogen_tpu_torch.profile_frame [--frames 10] [--out FILE]

The frame is the main path of `chip_smoke.py`: Cornell glossy, 512x512,
32 spp, 6 bounces, 262144-ray chunks, so 32 groups of 262144 rays, each a
`generate_rays` call and one megakernel launch. Printed:

  - the host-clock time of each of `--frames` frames (no profiler), with
    `torch.cuda.synchronize()` around each;
  - one group's `generate_rays`: host time to issue it, and its time to
    complete (host clock, synchronized), and one kernel launch's device time
    (CUDA events), each averaged over 10 calls;
  - from `torch.profiler` over one frame: the frame's time under the
    profiler, device busy time (the sum of the device-side rows' times:
    one stream, so they do not overlap), the idle share of the profiled
    frame and of the median unprofiled frame, the number of
    `cudaLaunchKernel` calls and `aten::` op calls, the megakernel's
    launches and device time, and the device kernels that take the most
    time.

The last line is one JSON object of these numbers; `--out` also writes it
to a file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

import halogen_tpu_torch as ht
from halogen_tpu_torch.integrator.camera import generate_rays
from halogen_tpu_torch.integrator.trace import _morton_pixel_order, _sampler_2d
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.sampler import sobol as sob
from halogen_tpu_torch.scene import cornell

CAM = dict(position=(0.0, 0.0, 3.2), target=(0.0, 0.0, 0.0), fov_deg=40.0)
SETTINGS = dict(width=512, height=512, samples_per_pixel=32, max_bounces=6,
                ray_chunk_size=262144)


def _self_device_us(evt) -> float:
    """Device time of a device-side row (a kernel or memcpy); 0 for a host
    op, whose device time repeats that of the kernels it launched."""
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: needs a CUDA device", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    scene = cornell.cornell_box(glossy=True).build(device=dev)
    cam = ht.make_camera(**CAM, device=dev)
    st = ht.RenderSettings(**SETTINGS)

    ht.render_frame(scene, cam, st, 0)  # build, warm-up
    torch.cuda.synchronize()
    frame_ms = []
    for f in range(args.frames):
        t0 = time.perf_counter()
        ht.render_frame(scene, cam, st, f + 1)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)

    # one group: 262144 pixels x 1 spp lane
    perm, _ = _morton_pixel_order(st.width, st.height)
    pix = torch.from_numpy(perm.astype(np.int64)).to(dev)
    seed = sob.pixel_seed(pix)
    sidx = sob.sample_index(1, torch.zeros_like(pix), st.samples_per_pixel)
    px, py = pix % st.width, pix // st.width

    def gen():
        return generate_rays(cam, px, py, st.width, st.height,
                             st.filter_radius, sidx, seed, _sampler_2d(st))

    reps = 10
    o, d = gen()
    torch.cuda.synchronize()
    issue_s = done_s = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        gen()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue_s += t1 - t0
        done_s += time.perf_counter() - t0
    tables = mk._scene_tables(scene)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st, tables)
    end.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(end) / reps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ht.render_frame(scene, cam, st, args.frames + 1)
        torch.cuda.synchronize()
        prof_frame_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    busy_ms = sum(_self_device_us(r) for r in rows) / 1e3
    launches = sum(r.count for r in rows if r.key == "cudaLaunchKernel")
    aten_calls = sum(r.count for r in rows if r.key.startswith("aten::"))
    top = sorted((r for r in rows if _self_device_us(r) > 0),
                 key=_self_device_us, reverse=True)[:8]
    mega = [r for r in rows if _self_device_us(r) > 0
            and "megakernel(" in r.key]

    result = {
        "card": card,
        "frames_ms": frame_ms,
        "frame_ms_min": min(frame_ms),
        "frame_ms_median": statistics.median(frame_ms),
        "frame_ms_max": max(frame_ms),
        "gen_rays_issue_ms": issue_s / reps * 1e3,
        "gen_rays_done_ms": done_s / reps * 1e3,
        "kernel_ms": kernel_ms,
        "profiled_frame_ms": prof_frame_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share_profiled": 1.0 - busy_ms / prof_frame_ms,
        # the device's work per frame is the same with and without the
        # profiler; its host overhead is not
        "device_idle_share": 1.0 - busy_ms / statistics.median(frame_ms),
        "megakernel_launches": sum(r.count for r in mega),
        "megakernel_ms": sum(_self_device_us(r) for r in mega) / 1e3,
        "cuda_launch_kernel_calls": launches,
        "aten_op_calls": aten_calls,
        "top_device_kernels": [
            {"name": r.key[:80], "count": r.count,
             "total_ms": _self_device_us(r) / 1e3} for r in top],
    }
    print(f"card: {card}")
    print(f"frames (host clock, ms): {frame_ms}")
    print(f"generate_rays per group: issue {result['gen_rays_issue_ms']:.3f} "
          f"ms, done {result['gen_rays_done_ms']:.3f} ms; kernel launch "
          f"{kernel_ms:.4f} ms (CUDA events)")
    print(f"profiled frame {prof_frame_ms:.1f} ms: device busy "
          f"{busy_ms:.2f} ms, idle "
          f"{result['device_idle_share_profiled']:.3f} "
          f"({result['device_idle_share']:.3f} of the median frame), "
          f"{launches} cudaLaunchKernel, {aten_calls} aten op calls; "
          f"megakernel {result['megakernel_launches']} launches, "
          f"{result['megakernel_ms']:.3f} ms")
    for r in result["top_device_kernels"]:
        print(f"  {r['total_ms']:9.3f} ms  {r['count']:6d}x  {r['name']}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
