"""Inverse-rendering demo (the JAX `scripts/inverse_demo.py`): perturb
the Cornell materials, recover them by gradient descent on the image loss
(`diff.grad.fit_materials`, area-light NEE on), and write before, target
and after images; the record adds the loss at a frame the fit never saw,
before and after.

    python -m halogen_tpu_torch.scripts.inverse_demo [--steps 80]
        [--out-dir renders/torch/inverse_demo] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

# a frame of the sample stream the fit's steps (frames 0 .. steps-1)
# never render
HELD_OUT_FRAME = 1 << 20


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="renders/torch/inverse_demo")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.cli.main import _save_png
    from halogen_tpu_torch.core.types import target_device
    from halogen_tpu_torch.diff.grad import fit_materials, render_loss
    from halogen_tpu_torch.parallel.scaling_bench import device_name
    from halogen_tpu_torch.scene import cornell

    dev = target_device("cpu" if args.cpu else "cuda")
    os.makedirs(args.out_dir, exist_ok=True)
    scene = cornell.cornell_box().build(device=dev)
    cam = ht.make_camera(position=(0, 0, 3.2), target=(0, 0, 0),
                         fov_deg=40, device=dev)
    st = ht.RenderSettings(width=args.width, height=args.width,
                           samples_per_pixel=args.spp, max_bounces=4,
                           light_importance_sampling=True,
                           ray_chunk_size=min(args.width ** 2, 65536))

    show = st.replace(samples_per_pixel=max(args.spp, 16))
    target = ht.render_frame(scene, cam, st, 0)
    _save_png(ht.render_frame(scene, cam, show, 0),
              os.path.join(args.out_dir, "target.png"))

    # Perturb: wash out every albedo and dim the light
    mats = scene.materials
    perturbed = dataclasses.replace(
        mats,
        albedo=torch.clamp(mats.albedo * 0.3 + 0.4, 0, 1),
        emissive=mats.emissive * 0.4,
    )
    scene_p = dataclasses.replace(scene, materials=perturbed)
    _save_png(ht.render_frame(scene_p, cam, show, 0),
              os.path.join(args.out_dir, "before.png"))

    params, losses = fit_materials(
        scene_p, cam, st, target, steps=args.steps, lr=args.lr,
        checkpoint_path=os.path.join(args.out_dir, "fit.npz"),
    )
    fitted = dataclasses.replace(scene, materials=params["materials"])
    _save_png(ht.render_frame(fitted, cam, show, 0),
              os.path.join(args.out_dir, "after.png"))
    held = ht.render_frame(scene, cam, st, HELD_OUT_FRAME)
    with torch.no_grad():
        held_out = {name: float(render_loss({"materials": m.materials},
                                            scene, cam, st, held,
                                            HELD_OUT_FRAME + 1))
                    for name, m in (("before", scene_p),
                                    ("after", fitted))}
    rec = {
        "initial_loss": losses[0], "final_loss": losses[-1],
        "steps": len(losses), "out_dir": args.out_dir,
        "held_out_loss_before": held_out["before"],
        "held_out_loss_after": held_out["after"],
        "device": device_name(dev),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
