"""Where the time of one main-path frame, or one gradient step, goes, on
one CUDA device.

Run from the root of a checkout:

    python3 -m halogen_tpu_torch.profile_frame [--scene S] [--grad]
        [--frames 10] [--out FILE]

with S one of cornell, glass, envmap_1024, glass_dragon, metal_dragon,
cornell_light, glow_orbs_light, glass_dragon_light.

The frame is a forward path of `chip_smoke.py`: by default the main path,
Cornell glossy, 512x512, 32 spp, 6 bounces, 262144-ray chunks, so 32
groups of 262144 rays, each one megakernel launch that makes its own
rays; `--scene glass` the glass-in-glass box at 512x512, 32 spp, 8
bounces (the medium-stack variant); `--scene envmap_1024` the JAX CLI
preset, material spheres under the gradient sky at 1024x1024, 16 spp, 4
bounces with env NEE (64 groups, each also a sky pass after the kernel);
`--scene glass_dragon` `bench.py`'s glass dragon (the reference's
Dragon_8k in glass around an air bubble, in the Cornell shell: 8,724
triangles) at 512x512, 32 spp, 12 bounces, through the megakernel's BVH
tier (B1d); `--scene metal_dragon` a 1,280-triangle metal dragon in the
Cornell shell (`chip_smoke.py` phase 31's) at 256x256, 32 spp, 12
bounces (the opaque BVH tier); `--scene cornell_light` the main path
with area-light NEE (B1e, `chip_smoke.py` phase 33's
cornell_glossy_512_light) and `--scene glow_orbs_light` `glow_orbs`
(emissive spheres) so (its glow_orbs_512_light); `--scene
glass_dragon_light` the glass dragon's frame with area-light NEE (B1b+e+d);
with an envmap, each group's sky pass is one launch of the sky kernel
(`kernels/sky.py`).
With `--grad` the step is `diff.render_loss_grad` instead, on the
adjoint's record route (each forward launch also records the transcript,
and the backward is the sweep alone; past `adjoint.RECORD_BUDGET` the
forward writes out its rays and the backward replays, or with light NEE
records each group again and sweeps): for Cornell
and glass at `bench.py`'s forward-plus-backward configuration, 256x256,
256 spp, so 64 groups, each one megakernel launch and, in the backward,
one adjoint launch; for the glass
dragon at its frame's configuration (512x512, 32 spp, 12 bounces: the
adjoint's BVH tier, B2b+d), and the
metal dragon at its frame's (B2+d); for the light-NEE scenes (B2+l:
the recording B1e and the light sweep, no replay) Cornell glossy and
`glow_orbs` at 256x256, 256 spp, 6 bounces and the glass dragon at its
frame's configuration; for
`envmap_1024` at the preset's frame with
{"materials", "env_mips"} (each group also the sky forward, the sky
backward and its per-texel sums, and the adjoint's sky and env-NEE
variant). Printed:

  - the host-clock time of each of `--frames` steps (no profiler), with
    `torch.cuda.synchronize()` around each, and the peak device memory
    they allocate (`torch.cuda.max_memory_allocated`);
  - one group's rays by `group_rays`, the plain version of the kernel's
    ray prologue (off the kernel route): host time to issue it, and its
    time to complete (host clock, synchronized); one launch from pixels:
    host time to issue it, and its time by CUDA events; each averaged over
    10 calls;
  - from `torch.profiler` over one frame: the frame's time under the
    profiler, device busy time (the sum of the device-side rows' times:
    one stream, so they do not overlap), the idle share of the profiled
    frame and of the median unprofiled frame, the number of
    `cudaLaunchKernel` calls and `aten::` op calls, the megakernel's and
    the adjoint's launches and device time, the sky kernels' (with
    `--grad` the backward's ordering and sums apart for the scatter of
    the sky's taps and that of the adjoint's env-NEE records), and the
    device kernels that take the most time.

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
from halogen_tpu_torch.integrator.trace import _morton_pixel_order, group_rays
from halogen_tpu_torch.kernels import megakernel as mk
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
# the JAX CLI's preset 3 (`cli/main.py:33-34, :93`)
ENVMAP_1024 = dict(width=1024, height=1024, samples_per_pixel=16,
                   max_bounces=4, use_envmap=True,
                   env_importance_sampling=True, env_mip_level=0,
                   ray_chunk_size=262144)


def _metal_dragon():
    """A 1,280-triangle metal dragon in the Cornell shell (`chip_smoke.py`
    phases 28 and 31)."""
    from halogen_tpu_torch.scene.material import Material

    box = cornell.cornell_box(with_spheres=False)
    verts, faces = meshes.dragon_mesh(3)
    box.add_mesh(verts, faces, Material.metal((0.9, 0.6, 0.5),
                                              roughness=0.4),
                 transform=meshes._scale_translate(0.55, (0.0, -0.45, 0.0)))
    return box


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
        device=dev), DRAGON_CAM, dict(SETTINGS, max_bounces=12),
        dict(SETTINGS, max_bounces=12)),
    "metal_dragon": (lambda dev: _metal_dragon().build(device=dev),
                     DRAGON_CAM, dict(SETTINGS, max_bounces=12, width=256,
                                      height=256),
                     dict(SETTINGS, max_bounces=12, width=256, height=256)),
    "envmap_1024": (lambda dev: cornell.material_demo_spheres().build(
        envmap=ht.Envmap.gradient_sky(), device=dev), SKY_CAM, ENVMAP_1024,
        ENVMAP_1024),
    "cornell_light": (lambda dev: cornell.cornell_box(glossy=True).build(
        device=dev), CAM, dict(SETTINGS, light_importance_sampling=True),
        dict(SETTINGS, light_importance_sampling=True, width=256,
             height=256, samples_per_pixel=256)),
    "glow_orbs_light": (lambda dev: cornell.glow_orbs().build(device=dev),
                        CAM, dict(SETTINGS, light_importance_sampling=True),
                        dict(SETTINGS, light_importance_sampling=True,
                             width=256, height=256, samples_per_pixel=256)),
    "glass_dragon_light": (lambda dev: meshes.glass_dragon_scene().build(
        device=dev), DRAGON_CAM, dict(SETTINGS, max_bounces=12,
                                      light_importance_sampling=True),
        dict(SETTINGS, max_bounces=12, light_importance_sampling=True)),
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


def _short(key: str) -> str:
    """A kernel's name without its namespace and arguments."""
    return key.replace("(anonymous namespace)::", "").split("(")[0][:40]


def _sky_scatters(prof) -> dict:
    """The device ms and launches of the sky backward's ordering
    (`sky_radix_*`) and sums (`sky_reduce_texels`), apart for the scatter
    of the sky's taps and that of the adjoint's env-NEE records: a group's
    backward runs the sky backward (its taps kernel, then the scatter of
    the taps), then the adjoint (then the scatter of its records), so a
    scatter kernel belongs to the one of the two that ran last before it
    on the stream."""
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    out, owner = {}, None
    for e in events:
        if "sky_backward_taps" in e.name:
            owner = "taps"
        elif "adjoint_kernel" in e.name or "adjoint_sweep" in e.name:
            owner = "records"
        stage = ("ordering" if "sky_radix_" in e.name else
                 "sums" if "sky_reduce_texels" in e.name else None)
        if stage is None or owner is None:
            continue
        row = out.setdefault(owner, {"ordering_ms": 0.0, "sums_ms": 0.0,
                                     "ordering_launches": 0,
                                     "sums_launches": 0})
        row[f"{stage}_ms"] += e.time_range.elapsed_us() / 1e3
        row[f"{stage}_launches"] += 1
    return out


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
        print(f"profile_frame: {args.scene} has no gradient step",
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
        params = {"materials": scene.materials}
        if st.use_envmap:
            params["env_mips"] = scene.env_mips
        step = lambda f: render_loss_grad(params, scene, cam, st, zeros, f)
    else:
        step = lambda f: ht.render_frame(scene, cam, st, f)

    step(0)  # build, warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    frame_ms = []
    for f in range(args.frames):
        t0 = time.perf_counter()
        step(f + 1)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    peak_bytes = torch.cuda.max_memory_allocated(dev)

    # one group: 262144 pixels x 1 spp lane
    perm, _ = _morton_pixel_order(st.width, st.height)
    pix = torch.from_numpy(perm[:262144].astype(np.int64)).to(dev)

    def gen():
        return group_rays(cam, st, 1, pix, 0, 1)

    reps = 10
    gen()
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
    env_tab = mk.env_table(scene)
    view = mk.pixel_view(cam, st, 1, pix)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        mk.trace_pixels_outputs(scene, view, 0, 1, st, tables, env_tab)
    launch_issue_ms = (time.perf_counter() - t0) / reps * 1e3
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
    # the kernels are templates: megakernel<false, false>(...),
    # megakernel_bvh<...> (the BVH tier; megakernel_record<...> and
    # megakernel_bvh_record<...> where they record the adjoint's
    # transcript; megakernel_light<...> and megakernel_bvh_light<...> with
    # light NEE, megakernel_light_record<...> and
    # megakernel_bvh_light_record<...> recording it) and so on; the adjoint
    # is the replay (adjoint_kernel) or the record route's sweep
    # (adjoint_sweep)
    kernel_rows = lambda *names: [r for r in rows if _self_device_us(r) > 0
                                  and any(f"{n}<" in r.key for n in names)]
    mega = kernel_rows("megakernel", "megakernel_bvh", "megakernel_record",
                       "megakernel_bvh_record", "megakernel_light",
                       "megakernel_bvh_light", "megakernel_light_record",
                       "megakernel_bvh_light_record")
    adjoint = kernel_rows("adjoint_kernel", "adjoint_sweep")
    sky_rows = [r for r in rows if _self_device_us(r) > 0
                and "sky_" in r.key]
    scatters = _sky_scatters(prof)

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
        "launch_issue_ms": launch_issue_ms,
        "kernel_ms": kernel_ms,
        "profiled_frame_ms": prof_frame_ms,
        "peak_memory_bytes": peak_bytes,
        "device_busy_ms": busy_ms,
        "device_idle_share_profiled": 1.0 - busy_ms / prof_frame_ms,
        # the device's work per frame is the same with and without the
        # profiler; its host overhead is not
        "device_idle_share": 1.0 - busy_ms / statistics.median(frame_ms),
        "megakernel_launches": sum(r.count for r in mega),
        "megakernel_ms": sum(_self_device_us(r) for r in mega) / 1e3,
        "adjoint_launches": sum(r.count for r in adjoint),
        "adjoint_ms": sum(_self_device_us(r) for r in adjoint) / 1e3,
        "sky_kernels": {_short(r.key): {"launches": r.count,
                                        "ms": _self_device_us(r) / 1e3}
                        for r in sky_rows},
        "sky_scatters": scatters,
        "cuda_launch_kernel_calls": launches,
        "aten_op_calls": aten_calls,
        "top_device_kernels": [
            {"name": r.key[:80], "count": r.count,
             "total_ms": _self_device_us(r) / 1e3} for r in top],
    }
    print(f"card: {card}")
    print(f"{result['step']} {args.scene} {st.width}x{st.height} "
          f"{st.samples_per_pixel} spp, steps (host clock, ms): {frame_ms}")
    print(f"group_rays (plain) per group: issue "
          f"{result['gen_rays_issue_ms']:.3f} ms, done "
          f"{result['gen_rays_done_ms']:.3f} ms; a launch from pixels: "
          f"issue {launch_issue_ms:.4f} ms (host), {kernel_ms:.4f} ms "
          f"(CUDA events)")
    print(f"profiled frame {prof_frame_ms:.1f} ms: device busy "
          f"{busy_ms:.2f} ms, idle "
          f"{result['device_idle_share_profiled']:.3f} "
          f"({result['device_idle_share']:.3f} of the median frame), "
          f"{launches} cudaLaunchKernel, {aten_calls} aten op calls; "
          f"megakernel {result['megakernel_launches']} launches, "
          f"{result['megakernel_ms']:.3f} ms; adjoint "
          f"{result['adjoint_launches']} launches, "
          f"{result['adjoint_ms']:.3f} ms; sky kernels "
          f"{result['sky_kernels']}; the sky backward's two scatters "
          f"{scatters}")
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
