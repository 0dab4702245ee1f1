"""Variance benchmark (the JAX `scripts/variance_bench.py`): the
convergence win of next-event estimation at equal spp.

Measures the error of K independent equal-spp frames against a high-spp
reference, with NEE on and off, on the two glossy-dominant ladder scenes
(Cornell glossy: area-light NEE; the material spheres under the sky:
envmap NEE), at the JAX script's sizes (48², 8 spp, 6 frames, a 256-spp
reference). Appends one JSON line per configuration to
`perf/torch/variance.jsonl` (or `--out`).

    python -m halogen_tpu_torch.scripts.variance_bench [--cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=48)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--ref-spp", type=int, default=256)
    ap.add_argument("--out", default="perf/torch/variance.jsonl")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.core.types import target_device
    from halogen_tpu_torch.parallel.scaling_bench import device_name
    from halogen_tpu_torch.scene import cornell
    from halogen_tpu_torch.scene.envmap import Envmap

    dev = target_device("cpu" if args.cpu else "cuda")
    card = device_name(dev)
    out_path = pathlib.Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    cam_c = ht.make_camera(position=(0, 0, 3.2), target=(0, 0, 0),
                           fov_deg=40, device=dev)
    cam_m = ht.make_camera(position=(0, 2.0, 6.0), target=(0, 0, -1),
                           fov_deg=45, device=dev)
    configs = {
        "cornell_glossy_lightnee": (
            cornell.cornell_box(glossy=True).build(device=dev),
            cam_c,
            dict(light_importance_sampling=True),
        ),
        "material_demo_envnee": (
            cornell.material_demo_spheres().build(
                envmap=Envmap.gradient_sky(), device=dev),
            cam_m,
            dict(use_envmap=True, env_importance_sampling=True,
                 env_mip_level=0),
        ),
    }

    w, spp, frames = args.width, args.spp, args.frames
    base = ht.RenderSettings(width=w, height=w, samples_per_pixel=spp,
                             max_bounces=4, ray_chunk_size=w * w)
    recs = []
    for name, (scene, cam, nee_kw) in configs.items():
        # high-spp reference (NEE on: both estimators are unbiased, the
        # lower-variance one makes the better truth)
        ref_st = base.replace(samples_per_pixel=args.ref_spp, **nee_kw)
        ref = ht.render_frame(scene, cam, ref_st, 0).cpu().numpy()

        rec = {"key": name, "width": w, "spp": spp, "frames": frames,
               "backend": dev.type, "device": card,
               "ts": time.strftime("%Y-%m-%d %H:%M:%S")}
        for tag, kw in (("nee_on", nee_kw), ("nee_off", {})):
            st = base.replace(**kw)
            mses = []
            for f in range(frames):
                img = ht.render_frame(scene, cam, st, f + 1).cpu().numpy()
                mses.append(float(np.mean((img - ref) ** 2)))
            rec[f"mse_{tag}"] = float(np.mean(mses))
        rec["variance_reduction_x"] = (rec["mse_nee_off"]
                                       / max(rec["mse_nee_on"], 1e-12))
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
