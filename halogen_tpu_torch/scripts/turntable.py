"""Turntable fly-around through the progressive `Renderer` (the JAX
`scripts/turntable.py`): the headless equivalent of the reference's
viewport loop (`HalogenRenderPass.Execute`, HalogenRenderPass.cs:270-357:
re-accumulate while the camera moves, reset on movement).

Orbits the camera around a scene; every stop calls `Renderer.set_camera`
(which fingerprints the camera and resets accumulation, the camera-moved
branch of Execute :279-291), accumulates `--frames` progressive frames,
and keeps the image. Writes a horizontal contact strip PNG and an
animated GIF, or, where PIL is not installed, the strip as `.npz` and no
GIF.

    python -m halogen_tpu_torch.scripts.turntable --scene glass_dragon
    # -> renders/torch/turntable_<scene>.png / .gif (or .npz)
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="glass_dragon",
                    choices=["glass_dragon", "dragons_hero", "cornell",
                             "testing_active"])
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--frames", type=int, default=4,
                    help="accumulated frames per view")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="path without suffix (default: "
                    "renders/torch/turntable_<scene>)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.core.types import target_device
    from halogen_tpu_torch.parallel.scaling_bench import device_name
    from halogen_tpu_torch.scene import cornell, meshes
    from halogen_tpu_torch.scene.envmap import Envmap

    dev = target_device("cpu" if args.cpu else "cuda")
    sky = Envmap.gradient_sky()
    if args.scene == "glass_dragon":
        scene = meshes.glass_dragon_scene().build(envmap=sky, device=dev)
        center, r, h, fov = (0.0, -0.3, 0.0), 4.5, 1.3, 45
        st_extra = dict(max_bounces=8, use_envmap=True)
    elif args.scene == "dragons_hero":
        scene = meshes.dragons_hero_scene().build(envmap=sky, device=dev)
        center, r, h, fov = (0.0, -0.2, 0.0), 5.0, 1.6, 45
        st_extra = dict(max_bounces=6, use_envmap=True)
    elif args.scene == "testing_active":
        from halogen_tpu_torch.scene.testing_scene import testing_scene

        scene = testing_scene(all_groups=False).build(envmap=sky,
                                                      device=dev)
        center, r, h, fov = (3.48, 1.2, 17.55), 4.5, 1.8, 60
        st_extra = dict(max_bounces=5, use_envmap=True)
    else:
        scene = cornell.cornell_box(glossy=True).build(device=dev)
        center, r, h, fov = (0.0, 0.0, 0.0), 3.2, 0.0, 40
        st_extra = dict(max_bounces=6)

    st = ht.RenderSettings(
        width=args.width, height=args.width,
        samples_per_pixel=args.spp,
        max_accumulated_frames=args.frames, unlimited_sampling=False,
        **st_extra)

    def cam_at(angle):
        pos = (center[0] + r * np.sin(angle), center[1] + h,
               center[2] + r * np.cos(angle))
        return ht.make_camera(position=pos, target=center, fov_deg=fov,
                              device=dev)

    renderer = ht.Renderer(scene, cam_at(0.0), st)
    views = []
    for i in range(args.views):
        # set_camera fingerprints the pose; a changed pose resets
        # FrameCount to 1 exactly like the reference's camera-moved path
        renderer.set_camera(cam_at(2 * np.pi * i / args.views))
        if int(renderer.state.frame_count) != 1:
            raise RuntimeError(f"view {i}: the camera move kept "
                               f"{int(renderer.state.frame_count)} frames")
        img = renderer.render()  # accumulates to max_accumulated_frames
        if not renderer.done:
            raise RuntimeError(f"view {i}: accumulation did not finish")
        views.append(np.asarray(img))
        print(f"view {i + 1}/{args.views}: mean={views[-1].mean():.4f}",
              flush=True)

    def to8(img):
        return (np.clip(img, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8)[
            ::-1]

    strip = np.concatenate([to8(v) for v in views], axis=1)
    out = args.out or f"renders/torch/turntable_{args.scene}"
    pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
    try:
        from PIL import Image
    except ImportError:
        written = [out + ".npz"]
        np.savez_compressed(written[0], strip=strip)
        print(f"wrote {written[0]}; no GIF: PIL is not installed")
    else:
        written = [out + ".png", out + ".gif"]
        Image.fromarray(strip).save(written[0])
        frames = [Image.fromarray(to8(v)) for v in views]
        frames[0].save(written[1], save_all=True,
                       append_images=frames[1:], duration=150, loop=0)
        print(f"wrote {written[0]} ({strip.shape[1]}x{strip.shape[0]}) "
              f"and {written[1]}")
    rec = {"scene": args.scene, "views": args.views, "frames": args.frames,
           "width": args.width, "spp": args.spp, "tris": scene.num_triangles,
           "view_means": [float(v.mean()) for v in views],
           "finite": bool(all(np.isfinite(v).all() for v in views)),
           "written": written, "device": device_name(dev)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
