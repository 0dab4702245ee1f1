"""Where the time of one main-path frame, or one gradient step, goes, on
one CUDA device.

Run from the root of a checkout:

    python3 -m halogen_tpu_torch.profile_frame [--scene S] [--grad]
        [--frames 10] [--out FILE]

with S one of cornell, glass, envmap_1024, glass_dragon.

The frame is a forward path of `chip_smoke.py`: by default the main path,
Cornell glossy, 512x512, 32 spp, 6 bounces, 262144-ray chunks, so 32
groups of 262144 rays, each a `generate_rays` call and one megakernel
launch; `--scene glass` the glass-in-glass box at 512x512, 32 spp, 8
bounces (the medium-stack variant); `--scene envmap_1024` the JAX CLI
preset, material spheres under the gradient sky at 1024x1024, 16 spp, 4
bounces with env NEE (64 groups, each also a sky pass after the kernel);
`--scene glass_dragon` `bench.py`'s glass dragon (the reference's
Dragon_8k in glass around an air bubble, in the Cornell shell: 8,724
triangles) at 512x512, 32 spp, 12 bounces, through the megakernel's BVH
tier (B1d).
With `--grad` the step is `diff.render_loss_grad` at `bench.py`'s
forward-plus-backward configuration instead: 256x256, 256 spp, so 64
groups, each a `generate_rays` call, one megakernel launch and, in the
backward, one adjoint launch (Cornell or glass). Printed:

  - the host-clock time of each of `--frames` steps (no profiler), with
    `torch.cuda.synchronize()` around each;
  - one group's `generate_rays`: host time to issue it, and its time to
    complete (host clock, synchronized), and one kernel launch's device time
    (CUDA events), each averaged over 10 calls;
  - from `torch.profiler` over one frame: the frame's time under the
    profiler, device busy time (the sum of the device-side rows' times:
    one stream, so they do not overlap), the idle share of the profiled
    frame and of the median unprofiled frame, the number of
    `cudaLaunchKernel` calls and `aten::` op calls, the megakernel's and
    the adjoint's launches and device time, and the device kernels that
    take the most time.

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
from halogen_tpu_torch.diff import render_loss_grad
from halogen_tpu_torch.integrator.camera import generate_rays
from halogen_tpu_torch.integrator.trace import _morton_pixel_order, _sampler_2d
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.sampler import sobol as sob
from halogen_tpu_torch.scene import cornell, meshes

CAM = dict(position=(0.0, 0.0, 3.2), target=(0.0, 0.0, 0.0), fov_deg=40.0)
SKY_CAM = dict(position=(0.0, 1.0, 6.0), target=(0.0, 0.5, 0.0),
               fov_deg=40.0)
# bench.py's glass_dragon camera
DRAGON_CAM = dict(position=(0.0, 1.5, 5.0), target=(0.0, -0.3, 0.0),
                  fov_deg=45.0)
SETTINGS = dict(width=512, height=512, samples_per_pixel=32, max_bounces=6,
                ray_chunk_size=262144)
GLASS = dict(max_bounces=8, max_transmission_bounces=8)
# scene -> (build, camera, frame settings, step settings for --grad)
SCENES = {
    "cornell": (lambda dev: cornell.cornell_box(glossy=True).build(
        device=dev), CAM, SETTINGS,
        dict(SETTINGS, width=256, height=256, samples_per_pixel=256)),
    "glass": (lambda dev: cornell.glass_sphere_box().build(device=dev), CAM,
              dict(SETTINGS, **GLASS),
              dict(SETTINGS, **GLASS, width=256, height=256,
                   samples_per_pixel=256)),
    "glass_dragon": (lambda dev: meshes.glass_dragon_scene().build(
        device=dev), DRAGON_CAM, dict(SETTINGS, max_bounces=12), None),
    "envmap_1024": (lambda dev: cornell.material_demo_spheres().build(
        envmap=ht.Envmap.gradient_sky(), device=dev), SKY_CAM,
        dict(width=1024, height=1024, samples_per_pixel=16, max_bounces=4,
             use_envmap=True, env_importance_sampling=True,
             env_mip_level=0, ray_chunk_size=262144), None),
}


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
    ap.add_argument("--scene", choices=sorted(SCENES), default="cornell")
    ap.add_argument("--grad", action="store_true",
                    help="profile a render_loss_grad step, not a frame")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: needs a CUDA device", file=sys.stderr)
        return 1
    build, cam_kw, frame_kw, grad_kw = SCENES[args.scene]
    if args.grad and grad_kw is None:
        print(f"profile_frame: {args.scene} has no gradient step yet "
              "(envmap gradients, ROADMAP A8; big scenes, A9)",
              file=sys.stderr)
        return 1
    kw = grad_kw if args.grad else frame_kw

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    scene = build(dev)
    cam = ht.make_camera(**cam_kw, device=dev)
    st = ht.RenderSettings(**kw)
    if args.grad:
        zeros = torch.zeros((st.height, st.width, 3), device=dev)
        step = lambda f: render_loss_grad({"materials": scene.materials},
                                          scene, cam, st, zeros, f)
    else:
        step = lambda f: ht.render_frame(scene, cam, st, f)

    step(0)  # build, warm-up
    torch.cuda.synchronize()
    frame_ms = []
    for f in range(args.frames):
        t0 = time.perf_counter()
        step(f + 1)
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
        step(args.frames + 1)
        torch.cuda.synchronize()
        prof_frame_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    busy_ms = sum(_self_device_us(r) for r in rows) / 1e3
    launches = sum(r.count for r in rows if r.key == "cudaLaunchKernel")
    aten_calls = sum(r.count for r in rows if r.key.startswith("aten::"))
    top = sorted((r for r in rows if _self_device_us(r) > 0),
                 key=_self_device_us, reverse=True)[:8]
    # the kernels are templates: megakernel<false, false>(...) and so on
    kernel_rows = lambda name: [r for r in rows if _self_device_us(r) > 0
                                and f"{name}<" in r.key]
    mega, adjoint = kernel_rows("megakernel"), kernel_rows("adjoint_kernel")

    result = {
        "card": card,
        "step": "render_loss_grad" if args.grad else "render_frame",
        "scene": args.scene,
        "settings": kw,
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
        "adjoint_launches": sum(r.count for r in adjoint),
        "adjoint_ms": sum(_self_device_us(r) for r in adjoint) / 1e3,
        "cuda_launch_kernel_calls": launches,
        "aten_op_calls": aten_calls,
        "top_device_kernels": [
            {"name": r.key[:80], "count": r.count,
             "total_ms": _self_device_us(r) / 1e3} for r in top],
    }
    print(f"card: {card}")
    print(f"{result['step']} {args.scene} {st.width}x{st.height} "
          f"{st.samples_per_pixel} spp, steps (host clock, ms): {frame_ms}")
    print(f"generate_rays per group: issue {result['gen_rays_issue_ms']:.3f} "
          f"ms, done {result['gen_rays_done_ms']:.3f} ms; kernel launch "
          f"{kernel_ms:.4f} ms (CUDA events)")
    print(f"profiled frame {prof_frame_ms:.1f} ms: device busy "
          f"{busy_ms:.2f} ms, idle "
          f"{result['device_idle_share_profiled']:.3f} "
          f"({result['device_idle_share']:.3f} of the median frame), "
          f"{launches} cudaLaunchKernel, {aten_calls} aten op calls; "
          f"megakernel {result['megakernel_launches']} launches, "
          f"{result['megakernel_ms']:.3f} ms; adjoint "
          f"{result['adjoint_launches']} launches, "
          f"{result['adjoint_ms']:.3f} ms")
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
