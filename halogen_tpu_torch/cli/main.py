"""Command-line renderer (PyTorch port of `halogen_tpu/cli/main.py`): the
headless equivalent of the reference's Unity editor loop (scene + settings
-> progressive render -> image on disk), with the benchmark ladder's
configurations as named presets.

Usage:
    python -m halogen_tpu_torch.cli render --preset cornell_256 --out out.png
    python -m halogen_tpu_torch.cli render --scene cornell --light-nee
    python -m halogen_tpu_torch.cli bench --preset cornell_glossy_512
    python -m halogen_tpu_torch.cli fit --steps 50 --out fitted.png
    python -m halogen_tpu_torch.cli fit --light-nee --steps 3 --width 64
    python -m halogen_tpu_torch.cli debug-sobol --out sobol.png
    python -m halogen_tpu_torch.cli render --preset dragons_hero
    torchrun --nproc-per-node=4 -m halogen_tpu_torch.cli render --sharded

Every command runs on the card (`--device cuda`, the default) unless it is
given `--device cpu`, where the plain PyTorch versions of the kernels run.
`render --sharded` (the `dragons_hero` preset sets it) renders each frame
over a process group (`parallel.sharding`): `torchrun`'s, one process a
card, or without it this process alone; rank 0 writes the image.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

# The project's forward-throughput target, Mrays/s per device
# (BASELINE.json's north star: >= 100 Mrays/s/chip fwd); `bench`'s
# vs_baseline is the ratio to it.
TARGET_MRAYS = 100.0

# ---------------------------------------------------------------------------
# The benchmark ladder's presets (BASELINE.json's configs)
# ---------------------------------------------------------------------------

PRESETS = {
    # 1. Cornell box, diffuse-only, 256x256, 4spp, 2 bounces (CPU-runnable)
    "cornell_256": dict(scene="cornell", width=256, spp=4, bounces=2,
                        frames=1),
    # 2. Cornell + glossy/emissive, focal blur, 512x512, 64spp
    "cornell_glossy_512": dict(scene="cornell_glossy", width=512, spp=64,
                               bounces=6, frames=1, aperture=2.0),
    # 3. Envmap scene with importance sampling + Blackman-Harris AA, 1024^2
    "envmap_1024": dict(scene="envmap_demo", width=1024, spp=16, bounces=4,
                        frames=1, envmap=True, env_nee=True),
    # 4. Glass dragon: nested dielectrics + absorption + RR
    "glass_dragon": dict(scene="glass_dragon", width=512, spp=32, bounces=12,
                         frames=1),
    # 5. Dragons hero scene, 4096spp (sharded; gradient step via `fit`)
    "dragons_hero": dict(scene="dragons", width=512, spp=64, bounces=8,
                         frames=64, sharded=True),
}


def _build_scene(name: str, use_envmap: bool, device):
    from halogen_tpu_torch.scene import cornell, meshes
    from halogen_tpu_torch.scene.envmap import Envmap

    env = Envmap.gradient_sky() if use_envmap else None
    builders = {
        "cornell": lambda: cornell.cornell_box(),
        "cornell_glossy": lambda: cornell.cornell_box(glossy=True),
        "material_demo": lambda: cornell.material_demo_spheres(),
        "envmap_demo": lambda: cornell.material_demo_spheres(),
        "glass_sphere_box": lambda: cornell.glass_sphere_box(),
        "glass_dragon": lambda: meshes.glass_dragon_scene(),
        "dragons": lambda: meshes.dragons_hero_scene(),
    }
    if name not in builders:
        raise SystemExit(f"unknown scene {name!r}; options: "
                         + ", ".join(builders))
    if name in ("material_demo", "envmap_demo", "dragons"):
        env = env or Envmap.gradient_sky()  # lit by the sky alone
    return builders[name]().build(envmap=env, device=device)


def _camera(args):
    import halogen_tpu_torch as ht

    return ht.make_camera(
        position=tuple(args.cam_pos), target=tuple(args.cam_target),
        fov_deg=args.fov, aperture_deg=args.aperture,
        focal_distance=args.focal_distance, device=args.device)


def _settings(args):
    import halogen_tpu_torch as ht

    return ht.RenderSettings(
        width=args.width, height=args.height or args.width,
        samples_per_pixel=args.spp, max_bounces=args.bounces,
        max_accumulated_frames=args.frames,
        unlimited_sampling=False,
        use_envmap=args.envmap,
        env_importance_sampling=args.env_nee,
        light_importance_sampling=args.light_nee,
        wavefront=args.wavefront,
        env_mip_level=0 if args.env_nee else 1,
        sampler=ht.SamplerKind.PRNG if args.prng else ht.SamplerKind.SOBOL,
        russian_roulette=not args.no_rr,
        ray_chunk_size=args.chunk,
    )


def _save_png(img, path: str, gamma: float = 2.2, flip: bool = True):
    """An 8-bit PNG of a linear image (row 0 is the bottom of the frame,
    so it is flipped), or `path + ".npy"` of the linear image where PIL is
    not installed."""
    import numpy as np

    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    im8 = (np.clip(img, 0.0, 1.0) ** (1.0 / gamma) * 255).astype(np.uint8)
    if flip:
        im8 = im8[::-1]
    try:
        from PIL import Image
    except ImportError:
        np.save(path + ".npy", img)
        return
    Image.fromarray(im8).save(path)


def _synchronize(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _add_render_args(p: argparse.ArgumentParser):
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--scene", default="cornell")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--bounces", type=int, default=6)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--envmap", action="store_true")
    p.add_argument("--env-nee", dest="env_nee", action="store_true",
                   help="envmap importance sampling (NEE + MIS)")
    p.add_argument("--light-nee", dest="light_nee", action="store_true",
                   help="area-light importance sampling (NEE + MIS)")
    p.add_argument("--wavefront", action="store_true",
                   help="wavefront scheduler: each bounce compacts the "
                   "live rays and traces only their blocks, for the same "
                   "image (where the lockstep runs: --device cpu, debug "
                   "views; ignored where the megakernel renders)")
    p.add_argument("--prng", action="store_true",
                   help="PCG PRNG sampler ablation")
    p.add_argument("--no-rr", action="store_true",
                   help="disable Russian roulette")
    p.add_argument("--sharded", action="store_true",
                   help="shard over the ranks of the process group "
                   "(torchrun's, or this process alone)")
    p.add_argument("--chunk", type=int, default=262144)
    p.add_argument("--fov", type=float, default=40.0)
    p.add_argument("--aperture", type=float, default=0.0)
    p.add_argument("--focal-distance", type=float, default=None)
    p.add_argument("--cam-pos", type=float, nargs=3, default=[0.0, 0.0, 3.2])
    p.add_argument("--cam-target", type=float, nargs=3,
                   default=[0.0, 0.0, 0.0])
    p.add_argument("--out", default="render.png")
    p.add_argument("--checkpoint", default=None,
                   help="save/resume accumulation state (npz)")
    _add_device_arg(p)


def _add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: the CUDA kernels) or cpu (their "
                   "plain PyTorch versions)")


def _apply_preset(args):
    if args.preset:
        for k, v in PRESETS[args.preset].items():
            setattr(args, k, v)
    return args


def cmd_render(args) -> int:
    import halogen_tpu_torch as ht
    from halogen_tpu_torch.utils.metrics import (
        RaysMeter,
        RenderStats,
        get_logger,
    )

    args = _apply_preset(args)
    log = get_logger()
    if args.sharded:
        return _render_sharded(args, log)
    scene = _build_scene(args.scene, args.envmap, args.device)
    cam = _camera(args)
    st = _settings(args)
    r = ht.Renderer(scene, cam, st)
    if args.checkpoint and os.path.exists(args.checkpoint):
        r.load_checkpoint(args.checkpoint)
        log.info("resumed at frame %d", int(r.state.frame_count))
    meter = RaysMeter()
    while not r.done:
        t0 = time.perf_counter()
        r.step()  # returns the image on the host: the frame has finished
        dt = time.perf_counter() - t0
        meter.add(st.samples_per_pixel * st.num_pixels)
        RenderStats(int(r.state.frame_count) - 1, st.width, st.height,
                    st.samples_per_pixel, dt).log(log)
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
    _save_png(r.image, args.out)
    log.info("wrote %s (%.1f Mrays/s trailing)", args.out,
             meter.mrays_per_sec)
    return 0


def _render_sharded(args, log) -> int:
    """`render --sharded` (the JAX CLI's, `cli/main.py:164-182`): frames
    1 .. frames through `render_frame_sharded` over a mesh of every rank,
    their running mean, `RenderStats` a frame; rank 0 writes the image.
    A group this call forms it also ends."""
    import torch.distributed as dist

    from halogen_tpu_torch.parallel.sharding import (
        init_distributed,
        make_render_mesh,
        render_frame_sharded,
    )
    from halogen_tpu_torch.utils.metrics import RaysMeter, RenderStats

    formed = init_distributed(device=args.device)
    try:
        scene = _build_scene(args.scene, args.envmap, args.device)
        cam = _camera(args)
        st = _settings(args)
        mesh = make_render_mesh()
        log.info("sharded over %d ranks, mesh %s", dist.get_world_size(),
                 mesh.shape)
        acc = None
        meter = RaysMeter()
        for f in range(args.frames):
            t0 = time.perf_counter()
            img = render_frame_sharded(scene, cam, st, f + 1, mesh)
            _synchronize(args.device)
            dt = time.perf_counter() - t0
            meter.add(st.samples_per_pixel * st.num_pixels)
            acc = img if acc is None else acc + (img - acc) / (f + 1)
            RenderStats(f + 1, st.width, st.height, st.samples_per_pixel,
                        dt).log(log)
        if dist.get_rank() == 0:
            _save_png(acc, args.out)
            log.info("wrote %s (%.1f Mrays/s trailing)", args.out,
                     meter.mrays_per_sec)
    finally:
        if formed:
            dist.destroy_process_group()
    return 0


def cmd_bench(args) -> int:
    """Timed forward throughput: one warm-up frame, then `frames` frames;
    prints one JSON line (the JAX CLI's keys) whose vs_baseline is the
    ratio to the project's TARGET_MRAYS."""
    from halogen_tpu_torch.integrator.trace import render_frame

    args = _apply_preset(args)
    scene = _build_scene(args.scene, args.envmap, args.device)
    cam = _camera(args)
    st = _settings(args)
    render_frame(scene, cam, st, 0)
    _synchronize(args.device)
    t0 = time.perf_counter()
    for f in range(max(args.frames, 1)):
        render_frame(scene, cam, st, f + 1)
    _synchronize(args.device)
    dt = time.perf_counter() - t0
    rays = st.samples_per_pixel * st.num_pixels * max(args.frames, 1)
    mrays = rays / dt / 1e6
    print(json.dumps({
        "metric": f"fwd_throughput_{args.preset or args.scene}",
        # 6 decimals: a 256-ray frame on a loaded CPU can take over 0.5 s,
        # and 3 (the JAX CLI's) round that real rate down to 0.0
        "value": round(mrays, 6),
        "unit": f"Mrays/s/{scene.device.type}",
        "vs_baseline": round(mrays / TARGET_MRAYS, 4),
    }))
    return 0


def cmd_fit(args) -> int:
    """Inverse-rendering demo: perturb the albedos, then recover them."""
    import torch

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.diff.grad import fit_materials
    from halogen_tpu_torch.utils.metrics import get_logger

    args = _apply_preset(args)
    log = get_logger()
    scene = _build_scene(args.scene, args.envmap, args.device)
    cam = _camera(args)
    st = _settings(args)

    target = ht.render_frame(scene, cam, st, 0)
    mats = scene.materials
    perturbed = dataclasses.replace(
        mats, albedo=torch.clamp(mats.albedo * 0.5 + 0.2, 0.0, 1.0))
    scene_p = dataclasses.replace(scene, materials=perturbed)
    params, losses = fit_materials(scene_p, cam, st, target,
                                   steps=args.steps, lr=args.lr)
    log.info("fit: loss %.3g -> %.3g over %d steps", losses[0], losses[-1],
             len(losses))
    with torch.no_grad():
        final = ht.render_frame(
            dataclasses.replace(scene, materials=params["materials"]), cam,
            st, 0)
    _save_png(final, args.out)
    print(json.dumps({"initial_loss": losses[0], "final_loss": losses[-1]}))
    return 0


def cmd_debug_sobol(args) -> int:
    """Sampler/filter visualizer (DebugSobol.compute)."""
    from halogen_tpu_torch.sampler.debug import sobol_filter_image

    img = sobol_filter_image(size=args.width, count=args.count,
                             device=args.device)
    _save_png(img, args.out, gamma=1.0, flip=False)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="halogen_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="progressive render to PNG")
    _add_render_args(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="timed forward throughput (JSON line)")
    _add_render_args(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("fit", help="inverse-rendering material fit demo")
    _add_render_args(p)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=5e-2)
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("debug-sobol", help="sampler distribution visualizer")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--count", type=int, default=100_000)
    p.add_argument("--out", default="sobol.png")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_debug_sobol)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
