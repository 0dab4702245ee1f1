"""Where the HDRI frame's kernel path and its plain path part, on the card.

`chip_smoke.py` phase 38 renders `meshes.outdoors_scene()` under
`hdr_io.procedural_hdri(2048)` (written as an EXR and read back by
`load_envmap`) with env NEE at mip level 0, 256x256, 16 spp, 4 bounces,
once through the kernels and once under `Fused.OFF`, and holds out the
pixels whose colors part past 1e-4. This script takes those pixels' rays
(every lane, as the kernel makes them from the pixels), traces them again
through the kernel with its transcript recorded (`megakernel.Record`) and
through the plain lockstep (`adjoint.record_transcript_reference`, the
same transcript in the same layout), and for every ray whose color parts
past 1e-4 finds the first bounce and the first recorded term that differ
(past 1e-6 of the value, or any difference of an id or a flag). It prints
a summary and writes the rays (their exact bits) and the per-ray results
to `--out` as JSON, which `perf/torch/hdri_parting_jax.py` reads on the
CPU to hold the JAX package's lockstep to both sides.

    python perf/torch/hdri_parting.py --out chiprun_out/hdri_parting.json
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

TOL = 1e-4  # chip_smoke.py PARITY_TOL
CAMERA = dict(position=(0.0, 0.6, 7.0), target=(0.0, -0.4, 0.0),
              fov_deg=50.0)
SETTINGS = dict(width=256, height=256, samples_per_pixel=16, max_bounces=4,
                use_envmap=True, env_importance_sampling=True,
                env_mip_level=0, ray_chunk_size=262144)
FRAME = 1
# the transcript's fields, slot-major [B + 1, N, ...] (`megakernel.Record`)
FIELDS = {"a": ("a_prev r", "a_prev g", "a_prev b", "t"),
          "word": ("word",), "nq": ("nee q r", "nee q g", "nee q b",
                                    "nee dterm"),
          "ngw": ("nee gterm", "nee weight"), "texel": ("texel",)}
OUTPUTS = ("color r", "color g", "color b", "miss atten r", "miss atten g",
           "miss atten b", "roughness", "dir x", "dir y", "dir z",
           "miss pcos", "miss nee")


def build(dev):
    """(scene, camera, settings) of phase 38's 256x256 frame on `dev`."""
    import numpy as np

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.scene import hdr_io, meshes

    with tempfile.TemporaryDirectory() as tmp:
        hdri = hdr_io.procedural_hdri(2048)
        path = os.path.join(tmp, "sky_2048.exr")
        hdr_io.write_exr(path, hdri)
        env = hdr_io.load_envmap(path)
    assert np.array_equal(env.mips[0], hdri)
    scene = meshes.outdoors_scene().build(envmap=env, device=dev)
    cam = ht.make_camera(**CAMERA, device=dev)
    return scene, cam, ht.RenderSettings(**SETTINGS)


def _first_apart(rec_k, rec_p, i: int):
    """(slot, field, kernel value, plain value) of the first recorded term
    of ray i that differs, in the slots both shaded, or None."""
    def apart(x, y, exact):
        return x != y if exact else abs(x - y) > 1e-6 * (1.0 + abs(y))

    shaded = min(int(rec_k.end[i]) & 0xFFFF, int(rec_p.end[i]) & 0xFFFF)
    for k in range(shaded):
        for name, labels in FIELDS.items():
            a = getattr(rec_k, name)[k, i].reshape(-1).tolist()
            b = getattr(rec_p, name)[k, i].reshape(-1).tolist()
            for label, x, y in zip(labels, a, b):
                if apart(x, y, name in ("word", "texel")):
                    return k, label, x, y
    return None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/hdri_parting.json")
    args = ap.parse_args(argv)

    import torch

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.integrator.trace import deferred_sky
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.kernels import sky as skyk
    from halogen_tpu_torch.parallel.scaling_bench import device_name

    dev = torch.device("cuda", 0)
    scene, cam, st = build(dev)
    k_img = ht.render_frame(scene, cam, st, FRAME)
    p_img = ht.render_frame(scene, cam, st.replace(fused=ht.Fused.OFF),
                            FRAME)
    apart = ((k_img - p_img).abs() > TOL + TOL * p_img.abs()).any(dim=2)
    pix = torch.nonzero(apart.reshape(-1)).flatten()
    n_pix = int(pix.shape[0])
    spp = st.samples_per_pixel
    if n_pix == 0:  # the frames agree on every pixel
        res = dict(device=device_name(dev), frame=FRAME, settings=SETTINGS,
                   camera=CAMERA, pixels_apart=0, pixels=st.num_pixels,
                   rays=0, rays_apart=0, apart=[])
        print(json.dumps({k: v for k, v in res.items() if k != "apart"}))
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(res))
        return res
    # the kernel's own rays of those pixels, every lane (pixel-major)
    view = mk.pixel_view(cam, st, FRAME, pix)
    _, o, d, sidx, seed = mk.trace_pixels_outputs(scene, view, 0, spp, st,
                                                  write_rays=True)
    n = o.shape[0]
    rec_k = mk.empty_record(n, st, True, dev)
    out_k = mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st,
                                   record=rec_k)
    out_p = mk.trace_color_fused_reference(scene, o, d, cam.far, sidx, seed,
                                           st)
    rec_p = adj.record_transcript_reference(scene, o, d, cam.far, sidx,
                                            seed, st)
    # the frame's kernel route shades the sky with the sky kernel
    sky_k = skyk.sky_color(scene, st, out_k).cpu()
    rec_k, rec_p = (mk.Record(*(None if t is None else t.cpu()
                                for t in r)) for r in (rec_k, rec_p))
    col_k, col_p = (deferred_sky(scene, st, x).cpu() for x in (out_k,
                                                               out_p))
    out_k, out_p = out_k.cpu(), out_p.cpu()
    o, d, sidx, seed = (x.cpu() for x in (o, d, sidx, seed))
    ray_apart = ((col_k - col_p).abs() > TOL + TOL * col_p.abs()).any(dim=1)
    sky_apart = ((sky_k - col_p).abs() > TOL + TOL * col_p.abs()).any(dim=1)
    idx = torch.nonzero(ray_apart).flatten().tolist()
    slots = st.max_bounces + 1
    rays, firsts = [], collections.Counter()

    def ulps(a, b):
        """|a - b| in float32 ulps, elementwise (same-sign values)."""
        ia, ib = (x.view(torch.int32).to(torch.int64) for x in (a, b))
        return (ia - ib).abs()

    # every bit of the path before the miss, and how far the miss's pdf
    # is: t of each shaded slot and the final direction, in ulps
    t_ulps = ulps(rec_k.a[..., 3].contiguous(), rec_p.a[..., 3].contiguous())
    dir_ulps = ulps(out_k[:, 7:10].contiguous(), out_p[:, 7:10].contiguous())
    pcos_rel = ((out_k[:, 10] - out_p[:, 10]).abs()
                / out_p[:, 10].abs().clamp_min(1e-30))
    end_k, end_p = rec_k.end.tolist(), rec_p.end.tolist()
    for i in idx:
        first = _first_apart(rec_k, rec_p, i)
        if end_k[i] != end_p[i] and (first is None or first[0] >= (
                min(end_k[i], end_p[i]) & 0xFFFF)):
            first = (min(end_k[i] & 0xFFFF, end_p[i] & 0xFFFF), "end",
                     end_k[i], end_p[i])
        outs = [OUTPUTS[j] for j in range(out_k.shape[1])
                if abs(float(out_k[i, j]) - float(out_p[i, j]))
                > 1e-6 * (1.0 + abs(float(out_p[i, j])))]
        firsts[(first[0], first[1]) if first else (None, "none")] += 1
        rays.append(dict(
            ray=i, pixel=int(pix[i // spp]), lane=i % spp,
            origin=o[i].tolist(), direction=d[i].tolist(),
            sample_idx=int(sidx[i]) & 0xFFFFFFFF,
            seed=int(seed[i]) & 0xFFFFFFFF,
            color_kernel=col_k[i].tolist(), color_plain=col_p[i].tolist(),
            color_sky_kernel=sky_k[i].tolist(),
            shaded_kernel=end_k[i] & 0xFFFF, shaded_plain=end_p[i] & 0xFFFF,
            first_apart=first, outputs_apart=outs,
            t_ulps=[int(t_ulps[k, i]) for k in range(
                min(end_k[i] & 0xFFFF, end_p[i] & 0xFFFF))],
            dir_ulps=dir_ulps[i].tolist(),
            miss_pcos=[float(out_k[i, 10]), float(out_p[i, 10])],
            miss_pcos_rel=float(pcos_rel[i]),
            texels=[rec_k.texel[k, i].item() for k in range(slots)],
            ngw_kernel=[rec_k.ngw[k, i].tolist() for k in range(slots)],
            ngw_plain=[rec_p.ngw[k, i].tolist() for k in range(slots)],
            mat=[rec_k.word[k, i].item() & 0xFF for k in range(slots)],
            spec=[bool(rec_k.word[k, i].item() & (1 << 16))
                  for k in range(slots)]))
    # the rays whose colors agree: how many of them differ in the record
    agree_terms = sum(
        1 for i in range(n) if not bool(ray_apart[i])
        and _first_apart(rec_k, rec_p, i) is not None)
    res = dict(
        device=device_name(dev), frame=FRAME, settings=SETTINGS, camera=CAMERA,
        pixels_apart=n_pix, pixels=st.num_pixels, rays=n,
        rays_apart=len(idx), rays_agreeing_with_a_term_apart=agree_terms,
        rays_apart_with_the_sky_kernel=int(sky_apart.sum()),
        pixels_with_a_ray_apart=len({i // spp for i in idx}),
        first_apart={f"{k[0]} {k[1]}": v for k, v in firsts.most_common()},
        rays_apart_with_every_t_and_dir_bit_equal=sum(
            1 for r in rays if max(r["t_ulps"] + r["dir_ulps"]) == 0),
        rays_apart_within_4_ulps_of_t_and_dir=sum(
            1 for r in rays if max(r["t_ulps"] + r["dir_ulps"]) <= 4),
        rays_apart_by_the_miss_pcos_alone=sum(
            1 for r in rays if r["outputs_apart"] == ["miss pcos"]),
        miss_pcos_rel_median=float(torch.tensor(
            [r["miss_pcos_rel"] for r in rays]).median()) if rays else 0.0,
        apart=rays)
    print(json.dumps({k: v for k, v in res.items() if k != "apart"}))
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
