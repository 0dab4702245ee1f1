"""The dragons hero scene end to end (the JAX `scripts/hero_run.py`,
BASELINE ladder config 5): 4096 accumulated spp through the sharded
renderer, then one sharded inverse-rendering gradient step, recorded in
`perf/torch/hero_run.json` with the image `renders/torch/hero.png` (and
its linear values, `hero.npz`).

The scene is three instances of the reference's Dragon_8k under the
gradient sky. Every frame goes through `parallel.sharding.
render_frame_sharded` over a mesh of every rank of the process group
(`torchrun`'s, one process a card, or this process alone); the step runs
`diff.grad.fit_materials` with `mesh=`. Rank 0 writes.

    python -m halogen_tpu_torch.scripts.hero_run             # the card
    python -m halogen_tpu_torch.scripts.hero_run --small     # CPU, tiny
    torchrun --nproc-per-node=4 -m halogen_tpu_torch.scripts.hero_run
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="the CPU at tiny shapes (64², 8 spp, 2 frames)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--spp-per-frame", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out-dir", default=None,
                    help="where the record and the image go (default: "
                    "perf/torch/ and renders/torch/)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch.distributed as dist

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.cli.main import _save_png, _synchronize
    from halogen_tpu_torch.core.types import target_device
    from halogen_tpu_torch.diff.grad import fit_materials
    from halogen_tpu_torch.parallel.scaling_bench import device_name
    from halogen_tpu_torch.parallel.sharding import (
        init_distributed,
        make_render_mesh,
        render_frame_sharded,
    )
    from halogen_tpu_torch.scene.envmap import Envmap
    from halogen_tpu_torch.scene.meshes import dragons_hero_scene

    dev = target_device("cpu" if args.cpu or args.small else "cuda")
    if args.small:
        width = args.width or 64
        spp_frame = args.spp_per_frame or 8
        frames = args.frames or 2
    else:
        width = args.width or 512
        spp_frame = args.spp_per_frame or 64
        frames = args.frames or 64  # 64 x 64 spp = 4096 accumulated spp

    formed = init_distributed(device=dev)
    try:
        mesh = make_render_mesh()
        scene = dragons_hero_scene().build(envmap=Envmap.gradient_sky(),
                                           device=dev)
        cam = ht.make_camera(position=(0, 1.5, 5.0), target=(0, -0.3, 0),
                             fov_deg=45, device=dev)
        st = ht.RenderSettings(
            width=width, height=width, samples_per_pixel=spp_frame,
            max_bounces=8, use_envmap=True,
            ray_chunk_size=min(width * width, 262144))

        # progressive accumulation across frames (running mean, the
        # reference's AccumulationShader)
        _synchronize(dev)
        t0 = time.perf_counter()
        acc = None
        for f in range(frames):
            img = render_frame_sharded(scene, cam, st, f + 1, mesh)
            acc = img if acc is None else acc + (img - acc) / (f + 1)
        _synchronize(dev)
        dt = time.perf_counter() - t0
        total_spp = spp_frame * frames
        acc_np = acc.cpu().numpy()

        # one sharded gradient step against the render, at up to 128²
        fit_w = min(width, 128)
        fit_st = st.replace(width=fit_w, height=fit_w,
                            samples_per_pixel=max(spp_frame // 8, 2),
                            ray_chunk_size=fit_w * fit_w)
        stride = width // fit_w
        _, losses = fit_materials(scene, cam, fit_st,
                                  acc_np[::stride, ::stride], steps=1,
                                  lr=1e-2, mesh=mesh)
        rec = {
            "key": "hero_small" if args.small else "hero_dragons_4096spp",
            "backend": dev.type,
            "devices": dist.get_world_size(),
            "mesh": mesh.shape,
            "width": width,
            "total_spp": total_spp,
            "frames": frames,
            "bounces": st.max_bounces,
            "tris": scene.num_triangles,
            "render_s": dt,
            "mrays_per_s": total_spp * width * width / dt / 1e6,
            "mean_radiance": float(acc_np.mean()),
            "finite": bool(np.isfinite(acc_np).all()),
            "grad_step_loss": float(losses[0]),
            "device": device_name(dev),
            "ts": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        if dist.get_rank() == 0:
            out = pathlib.Path(args.out_dir) if args.out_dir else None
            renders = out or pathlib.Path("renders/torch")
            perf = out or pathlib.Path("perf/torch")
            renders.mkdir(parents=True, exist_ok=True)
            perf.mkdir(parents=True, exist_ok=True)
            _save_png(acc_np, str(renders / "hero.png"))
            np.savez_compressed(renders / "hero.npz", image=acc_np)
            with open(perf / "hero_run.json", "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
    finally:
        if formed:
            dist.destroy_process_group()
    return rec


if __name__ == "__main__":
    main()
