"""Scaling benchmark of the sharded renderer (PyTorch port of
`halogen_tpu/parallel/scaling_bench.py`).

Sharded-render throughput over meshes of 1, 2, 4, ... ranks of the
default process group (and all of them), each a subgroup of the first
ranks, with the parallel efficiency against one rank; and weak scaling,
a fixed share of work a rank, beside a contention control. One process a
card: run it under `torchrun`, or alone for the one size one card gives:

    torchrun --nproc-per-node=4 -m halogen_tpu_torch.parallel.scaling_bench
    python -m halogen_tpu_torch.parallel.scaling_bench --weak
    python -m halogen_tpu_torch.parallel.scaling_bench --device cpu

Every record names the device it ran on: the card's name and power limit
as `nvidia-smi` gives them, or "cpu".
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
import torch.distributed as dist


def device_name(device) -> str:
    """The card's name and power limit (`nvidia-smi --query-gpu=name,
    power.limit`), or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _sizes(world: int, powers_only: bool = False) -> list:
    sizes, d = [], 1
    while d <= world:
        sizes.append(d)
        d *= 2
    if not powers_only and sizes[-1] != world:
        sizes.append(world)
    return sizes


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _from_rank0(records: list) -> list:
    """Rank 0's records on every rank."""
    box = [records]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _cornell(device):
    import halogen_tpu_torch as ht
    from halogen_tpu_torch.scene import cornell

    return (cornell.cornell_box(glossy=True).build(device=device),
            ht.make_camera(position=(0, 0, 3.2), target=(0, 0, 0),
                           fov_deg=40, device=device))


def run_scaling_bench(width=256, spp=8, bounces=4, frames=2, spp_shards=1,
                      scene=None, camera=None, settings=None,
                      device="cuda") -> list:
    """[{devices, mrays_per_sec, efficiency, device}] over meshes of the
    first 1, 2, 4, ... ranks (and all); every rank must call it, and every
    rank gets rank 0's records (its clock: it is in every mesh)."""
    import halogen_tpu_torch as ht
    from halogen_tpu_torch.parallel.sharding import (
        make_render_mesh,
        render_frame_sharded,
    )

    if scene is None:
        scene, camera = _cornell(device)
    if settings is None:
        settings = ht.RenderSettings(
            width=width, height=width, samples_per_pixel=spp,
            max_bounces=bounces, ray_chunk_size=min(width * width, 262144))
    name = device_name(scene.device)
    results, base = [], None
    for nd in _sizes(dist.get_world_size()):
        n_spp = spp_shards if nd % spp_shards == 0 and nd >= spp_shards else 1
        mesh = make_render_mesh(nd // n_spp, n_spp, ranks=range(nd))
        if mesh.member:
            render_frame_sharded(scene, camera, settings, 0, mesh)
            _sync(scene.device)
            t0 = time.perf_counter()
            for f in range(frames):
                render_frame_sharded(scene, camera, settings, f + 1, mesh)
            _sync(scene.device)
            dt = time.perf_counter() - t0
        dist.barrier()
        if dist.get_rank() == 0:
            rays = settings.samples_per_pixel * settings.num_pixels * frames
            mrays = rays / dt / 1e6
            base = mrays if base is None else base
            results.append({"devices": nd, "mrays_per_sec": mrays,
                            "efficiency": mrays / (base * nd),
                            "device": name})
    return _from_rank0(results)


def run_weak_scaling_bench(base_height=64, width=256, spp=8, bounces=4,
                           frames=2, device="cuda") -> list:
    """Weak scaling: a fixed share of work a rank (the image's height is
    base_height times the ranks, pixel-sharded), so the ideal wall time is
    flat and the efficiency is t(1) / t(n). Beside it a contention
    control: a fixed batched matmul on every rank of the mesh, with no
    collective; the renderer's efficiency over the control's is the
    sharded program's own (collectives, load imbalance). Min of 3
    interleaved samples each. Every rank must call it."""
    import halogen_tpu_torch as ht
    from halogen_tpu_torch.parallel.sharding import (
        make_render_mesh,
        render_frame_sharded,
    )

    scene, camera = _cornell(device)
    dev = scene.device
    name = device_name(dev)
    results, t_base, c_base = [], None, None
    for nd in _sizes(dist.get_world_size(), powers_only=True):
        settings = ht.RenderSettings(
            width=width, height=base_height * nd, samples_per_pixel=spp,
            max_bounces=bounces, ray_chunk_size=width * base_height * spp)
        mesh = make_render_mesh(nd, 1, ranks=range(nd))
        x = torch.ones((512, 512), device=dev)

        def work(a):
            for r in range(40):
                a = torch.tanh(a @ a * 1e-3 + r)
            return a

        dt = ctl = float("inf")
        if mesh.member:
            render_frame_sharded(scene, camera, settings, 0, mesh)
            work(x)
            _sync(dev)
            for rep in range(3):
                t0 = time.perf_counter()
                for f in range(frames):
                    render_frame_sharded(scene, camera, settings,
                                         rep * frames + f + 1, mesh)
                _sync(dev)
                dt = min(dt, (time.perf_counter() - t0) / frames)
                t0 = time.perf_counter()
                work(x)
                _sync(dev)
                ctl = min(ctl, time.perf_counter() - t0)
        dist.barrier()
        if dist.get_rank() == 0:
            t_base = dt if t_base is None else t_base
            c_base = ctl if c_base is None else c_base
            eff, ctl_eff = t_base / dt, c_base / ctl
            results.append({
                "devices": nd, "sec_per_frame": dt, "weak_efficiency": eff,
                "control_efficiency": ctl_eff,
                "program_efficiency": min(eff / max(ctl_eff, 1e-9), 1.0),
                "device": name})
    return _from_rank0(results)


def main(argv=None) -> int:
    from halogen_tpu_torch.parallel.sharding import init_distributed

    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--spp-shards", type=int, default=1)
    ap.add_argument("--weak", action="store_true",
                    help="weak scaling (fixed work a rank) and a "
                    "contention control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    formed = init_distributed(device=args.device)
    try:
        if args.weak:
            recs = run_weak_scaling_bench(width=args.width, spp=args.spp,
                                          bounces=args.bounces,
                                          frames=args.frames,
                                          device=args.device)
        else:
            recs = run_scaling_bench(args.width, args.spp, args.bounces,
                                     args.frames, args.spp_shards,
                                     device=args.device)
        if dist.get_rank() == 0:
            for rec in recs:
                print(json.dumps(rec))
    finally:
        if formed:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
