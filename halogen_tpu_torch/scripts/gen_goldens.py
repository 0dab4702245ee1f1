"""Render the six golden configurations of `tests/test_golden.py` (the
JAX `scripts/gen_goldens.py`) through the port, write each frame to
`--out-dir` (default `tests/golden_torch/` of the checkout) and hold it
against the committed JAX golden `tests/golden/<name>.npz` at
`tests/test_golden.py`'s bounds (the frame's mean absolute error and its
worst pixel).

    python -m halogen_tpu_torch.scripts.gen_goldens [--cpu]
        [--only cornell_diffuse glass_box] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
JAX_GOLDENS = ROOT / "tests" / "golden"

# (MAE, worst pixel) bounds of tests/test_golden.py (TOLS and its
# default): the testing_composite's giant emissive spheres make fireflies
# of single paths, so its worst pixel is loose
DEFAULT_TOLS = (5e-3, 0.15)
TOLS = {
    "testing_composite": (2e-2, 16.0),
    "testing_active": (5e-3, 1.0),
}


def configs(device="cuda"):
    """Name -> (scene, camera, settings, frame): the JAX `configs()`, on
    `device`."""
    import halogen_tpu_torch as ht
    from halogen_tpu_torch.scene import cornell
    from halogen_tpu_torch.scene.envmap import Envmap
    from halogen_tpu_torch.scene.testing_scene import (
        testing_scene,
        testing_scene_camera,
    )

    cam = ht.make_camera(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40,
                         device=device)
    settings = lambda **kw: ht.RenderSettings(width=64, height=64,
                                              samples_per_pixel=8,
                                              ray_chunk_size=4096, **kw)
    return {
        # ladder 1: diffuse Cornell (64² stand-in for the 256² config)
        "cornell_diffuse": (
            lambda: cornell.cornell_box().build(device=device), cam,
            settings(max_bounces=2), 1),
        # ladder 2: glossy/emissive Cornell with focal blur
        "cornell_glossy_dof": (
            lambda: cornell.cornell_box(glossy=True).build(device=device),
            ht.make_camera(position=(0, 0, 3.2), target=(0, 0, 0),
                           fov_deg=40, aperture_deg=2.0, focal_distance=3.2,
                           device=device),
            settings(max_bounces=4), 1),
        # ladder 3: envmap NEE + Blackman-Harris AA
        "envmap_nee": (
            lambda: cornell.material_demo_spheres().build(
                envmap=Envmap.gradient_sky(), device=device),
            ht.make_camera(position=(0, 1.0, 6.0), target=(0, 0.5, 0),
                           fov_deg=40, device=device),
            settings(max_bounces=4, use_envmap=True,
                     env_importance_sampling=True), 1),
        # ladder 4: nested dielectrics + absorption + RR
        "glass_box": (
            lambda: cornell.glass_sphere_box().build(device=device), cam,
            settings(max_bounces=8, max_transmission_bounces=8), 1),
        # the reference's Testing Scene: every group viewed into its
        # Cornell group, and the shipped active set through its camera
        "testing_composite": (
            lambda: testing_scene(all_groups=True).build(
                envmap=Envmap.gradient_sky(), device=device),
            ht.make_camera(position=(3.48, 1.8, 12.2),
                           target=(3.48, 1.0, 17.55), fov_deg=60, near=0.6,
                           far=1000, device=device),
            ht.RenderSettings(width=128, height=128, samples_per_pixel=4,
                              max_bounces=5, use_envmap=True,
                              ray_chunk_size=16384), 1),
        "testing_active": (
            lambda: testing_scene(all_groups=False).build(
                envmap=Envmap.gradient_sky(), device=device),
            testing_scene_camera(device=device),
            settings(max_bounces=4, use_envmap=True), 1),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=str(ROOT / "tests" / "golden_torch"))
    ap.add_argument("--only", nargs="+", default=None,
                    help="render only these configurations")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.core.types import target_device
    from halogen_tpu_torch.parallel.scaling_bench import device_name

    dev = target_device("cpu" if args.cpu else "cuda")
    card = device_name(dev)
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    recs = []
    for name, (build, cam, st, frame) in configs(dev).items():
        if args.only and name not in args.only:
            continue
        img = ht.render_frame(build(), cam, st, frame).cpu().numpy()
        np.savez_compressed(out_dir / f"{name}.npz", image=img)
        golden = np.load(JAX_GOLDENS / f"{name}.npz")["image"]
        mae_tol, worst_tol = TOLS.get(name, DEFAULT_TOLS)
        diff = np.abs(img - golden)
        rec = {"name": name, "shape": list(img.shape),
               "mean": float(img.mean()), "max": float(img.max()),
               "finite": bool(np.isfinite(img).all()),
               "mae": float(diff.mean()), "worst": float(diff.max()),
               "mae_tol": mae_tol, "worst_tol": worst_tol,
               "within": bool(diff.mean() < mae_tol
                              and diff.max() < worst_tol),
               "device": card}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
