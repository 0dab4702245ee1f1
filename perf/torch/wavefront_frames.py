"""Frame time with `RenderSettings.wavefront` off and on, wherever the
lockstep runs (`Fused.OFF`, a debug view): three scenes, each frame
rendered lockstep, wavefront, wavefront, lockstep, the images compared
bit for bit. Prints one JSON line a scene with the device's name (the
card's name and power limit on the card).

    python perf/torch/wavefront_frames.py [--cpu] [--width 64] [--spp 4]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.core.types import target_device
    from halogen_tpu_torch.integrator import trace
    from halogen_tpu_torch.parallel.scaling_bench import device_name
    from halogen_tpu_torch.scene import cornell, meshes, testing_scene
    from halogen_tpu_torch.scene.envmap import Envmap

    dev = target_device("cpu" if args.cpu else "cuda")
    w = args.width
    off = ht.Fused.OFF
    cases = {
        "glass dragon, Fused.OFF, 12 bounces": (
            meshes.glass_dragon_scene().build(device=dev),
            ht.make_camera(position=(0.0, 1.5, 5.0), target=(0.0, -0.3, 0.0),
                           fov_deg=45.0, device=dev),
            ht.RenderSettings(width=w, height=w, samples_per_pixel=args.spp,
                              max_bounces=12, fused=off)),
        "material spheres under the sky, Fused.OFF, 8 bounces": (
            cornell.material_demo_spheres().build(
                envmap=Envmap.gradient_sky(), device=dev),
            ht.make_camera(position=(0, 0, 3.2), target=(0, 0, 0),
                           fov_deg=40, device=dev),
            ht.RenderSettings(width=w, height=w, samples_per_pixel=args.spp,
                              max_bounces=8, use_envmap=True, fused=off)),
        "testing_scene(False), RAY_TRIANGLE_TESTS, 1 spp": (
            testing_scene.testing_scene(False).build(device=dev),
            testing_scene.testing_scene_camera(device=dev),
            ht.RenderSettings(width=w, height=w, samples_per_pixel=1,
                              debug_mode=ht.DebugMode.RAY_TRIANGLE_TESTS)),
    }

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    out = []
    for name, (scene, cam, st) in cases.items():
        ms, imgs, syncs = {}, {}, 0
        for wave in (False, True, True, False):
            trace.WAVEFRONT_SYNCS = 0
            sync()
            t0 = time.perf_counter()
            imgs[wave] = ht.render_frame(scene, cam,
                                         st.replace(wavefront=wave), 1)
            sync()
            ms.setdefault(wave, []).append((time.perf_counter() - t0) * 1e3)
            syncs = max(syncs, trace.WAVEFRONT_SYNCS)
        rec = {"scene": name, "width": w, "height": w,
               "spp": st.samples_per_pixel, "max_bounces": st.max_bounces,
               "lockstep_ms": ms[False], "wavefront_ms": ms[True],
               "wavefront_host_syncs": syncs,
               "bit_for_bit": bool(torch.equal(imgs[False], imgs[True])),
               "device": device_name(dev)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
