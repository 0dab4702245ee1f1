"""Per-launch times of the port's hand-written kernels at the launch shapes
of `chip_smoke.py`, on one CUDA device; a tool to compare two versions of
the kernels on one card.

Run from the root of a checkout:

    python3 halogen_tpu_torch/kernel_times.py [--tree DIR] [--only NAME ...]
        [--no-refill] [--out FILE]

`--tree DIR` times the package of another checkout of the port (say a
parent commit unpacked with `git archive` into a git-ignored directory):
this script imports `halogen_tpu_torch` from DIR, which builds its own
kernels, so that two versions run the same script on the same rays (each
tree's camera and sampler make them, and both share that code). Run the
versions in turns (parent, new, new, parent) in one call on one card.

The launch shapes, 262144 rays each (`chip_smoke.py`'s phases):
  - B1a and B2: Cornell glossy, the first Morton-ordered group of a 512x512
    32 spp frame, 6 bounces (phases 5, 8);
  - B1b and B2b: the glass-in-glass box, the same pixels, 8 bounces
    (phases 13, 15), and B2b at 16 bounces; where the tree's adjoint has
    transcript routes, B2 and B2b also through each route;
  - B1c: the material spheres under the sky with env NEE, the first
    262144 Morton-ordered pixels of the 1024x1024 `envmap_1024` frame, 4
    bounces (phase 13);
  - the BVH tier on the glass dragon camera's rays (phase 19): B1b+d (the
    glass dragon, 12 bounces), B1d and B1c+d (a 1,280-triangle dragon
    under the sky, 4 bounces, without and with env NEE), B1b+c+d (the
    glass dragon under the sky with env NEE, 12 bounces);
  - B3 on those camera rays and on one bounce's rays of the glass dragon;
  - where the tree has area-light NEE, B1e on B1a's rays with light NEE,
    and on the same rays B1a and B1e through `glow_orbs` (`B1a glow_orbs`,
    `B1e glow_orbs`: its emitters are spheres), B1b+e (the glass box, 8
    bounces), B1c+e (Cornell glossy under the sky with env NEE and light
    NEE) and B1b+c+e (the glass box so, 8 bounces); where the tree has the
    brute tier's light-NEE probe, B1e's shadow tests alone on both scenes
    (`B1e probe: no test`, every draw visible; `closest only`, the full
    scan; `kernel only`, the culled one; likewise `B1e glow_orbs probe:
    ...`); B1b+e+d on B1b+d's (`chip_smoke.py` phase 32), B1e+d on the same
    rays through the 1,280-triangle metal dragon in the Cornell shell (its
    ceiling panel the light), 12 bounces, and on the testing scene
    (`testing_scene(False)`, its camera's first 262144 rays of a 512x512
    32 spp frame, 4 bounces: `B1e+d testing`);
  - where the tree has them, the adjoint's BVH and sky variants on the
    same rays as their forward kernels: B2b+d (the glass dragon, 12
    bounces), B2+d (a 1,280-triangle metal dragon in the Cornell shell, 12
    bounces), B2c+d (the 1,280-triangle dragon under the sky, 4 bounces),
    B2c+n+d (the same dragon with env NEE), B2c and B2c+n (the
    `envmap_1024` rays, without and with env NEE), each with a random
    cotangent of the miss attenuation and roughness; where the tree has
    the record route, the forward recording the transcript (`B1b+d
    record`) and the sweep over it (`B2b+d sweep`, `B2+d sweep`, `B2c+d
    sweep` and `B2c+n+d sweep`) on the same rays and cotangents as the
    replay's jobs of the same names; where the tree's brute tier records
    too, its recording forwards (`B1a record`, `B1b record`, `B1c record`)
    on B1a's, B1b's and B1c's rays and its sweeps (`B2 sweep`, `B2b
    sweep`, `B2c sweep`, `B2c+n sweep`) on the rays and cotangents of the
    replay's jobs of the same names, and B1e+d's light-NEE probe on
    B1b+e+d's rays, the shadow walks alone (`B1b+e+d probe: closest only`,
    `kernel only`, the any-hit walk, `no test`: every draw visible); where
    the tree records area-light NEE (B2+l), the recording forwards `B1e
    record` (B1e's rays), `B1e+d record` and `B1b+e+d record` (B1e+d's and
    B1b+e+d's) and the light sweeps over their records, `B2+l sweep`,
    `B2+l glow_orbs sweep` (B1e glow_orbs' rays), `B2+l+d sweep` and
    `B2b+l+d sweep`; and the sky pair on the `envmap_1024` rays' outputs
    (`sky forward`; `sky
    backward`, its taps, the ordering by texel and the per-texel sums),
    and the backward's stages alone: `sky backward taps` (where the tree's
    taps kernel counts the ordering's first pass, with it), `sky
    ordering` (with its first pass's count) and `sky sums` of the taps,
    and the whole scatter of the taps (`sky scatter: taps`) and of
    B2c+n's env-NEE records at the same rays (`sky scatter: records`).
Each is launched once (a warm-up), then timed by CUDA events over two runs
of 10 launches, and by `torch.profiler` device time per launch of the
kernel itself (the adjoint's block-sum kernel is in its event time only);
the sky backward and its stages by the device time of every kernel a call
launches, per call, split by kernel name.
Printed: the card's name and power limit, each kernel's registers and
spills from nvcc's `-Xptxas -v`, the times, a hash of each job's result
(the adjoint's [K, 12|13], the forward's [N, 10|12] outputs; equal
hashes: equal bits, across trees and routes),
and as the last line one JSON object of them; `--out` also writes that
line to a file.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="root of the checkout whose package to time")
    ap.add_argument("--only", nargs="*", default=None,
                    help="time only these kernels (names as printed)")
    ap.add_argument("--no-refill", action="store_true",
                    help="launch the forward kernel with one ray a thread "
                    "instead of persistent warps that refill their free "
                    "lanes (a tree whose kernel refills)")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def _resources(log: str) -> dict:
    """{kernel entry (mangled name): [registers, spill-store bytes]} from
    nvcc's `-Xptxas -v` output."""
    out, cur, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = [int(m.group(1)), spill]
    return out


def _sky_stages(sky_k, adj, mk, spheres, st_e, r_e, out_e, ct_e):
    """The sky backward's stages on the `envmap_1024` rays, each timed per
    call with every device kernel it launches: the taps; the ordering by
    texel of the taps and the per-texel sums (this tree's kernels where it
    has them, `order_texels`'s; else `torch.sort(stable=True)`, then its
    sum kernel on the sorted keys); and the whole scatter of the taps and
    of the adjoint's env-NEE records (B2c+n at the same rays)."""
    import ctypes

    import torch

    dev = out_e.device
    _, keys, wts = sky_k.sky_backward(spheres, st_e, out_e, ct_e)
    n_tex = sum(int(m.shape[0] * m.shape[1]) for m in spheres.env_mips)
    taps = lambda: sky_k.sky_backward(spheres, st_e, out_e, ct_e)
    if hasattr(sky_k, "_workspace"):  # the taps kernel counts the first pass
        order = sky_k._workspace(keys.shape[0], n_tex, dev)
        taps = lambda: sky_k.sky_backward(spheres, st_e, out_e, ct_e,
                                          order=order)
    jobs = {"sky backward taps": (taps, None)}
    if hasattr(sky_k, "order_texels"):
        st = torch.cuda.current_stream(dev).cuda_stream
        ordered = sky_k._order(keys, n_tex, st)
        jobs["sky ordering"] = (lambda: sky_k._order(keys, n_tex, st), None)
        jobs["sky sums"] = (lambda: sky_k._sums(*ordered, wts, n_tex, st),
                            None)
    else:
        ordered, perm = torch.sort(keys, stable=True)

        def sums():
            out = torch.empty((n_tex, 3), device=dev)
            err = sky_k._lib().halogen_sky_scatter(
                ordered.data_ptr(), perm.data_ptr(), wts.data_ptr(),
                out.data_ptr(), keys.shape[0], n_tex,
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
            if err != 0:
                raise RuntimeError(f"sky scatter launch failed: {err}")

        jobs["sky ordering"] = (lambda: torch.sort(keys, stable=True), None)
        jobs["sky sums"] = (sums, None)
    jobs["sky scatter: taps"] = (
        lambda: sky_k.scatter_texels(keys, wts, n_tex), None)
    c, o_, d_, s_, e_ = r_e
    n, slots = o_.shape[0], st_e.max_bounces + 1
    rec = (torch.empty((n, slots), dtype=torch.int32, device=dev),
           torch.empty((n, slots, 3), device=dev))
    d4 = sky_k.sky_backward(spheres, st_e, out_e, ct_e)[0]
    adj._launch(spheres, o_, d_, c.far, s_, e_, ct_e, st_e,
                mk._scene_tables(spheres), gsky=d4,
                env_tab=mk.env_table(spheres), records=rec)
    h, w = spheres.env_cdf.pdf.shape
    jobs["sky scatter: records"] = (lambda: sky_k.scatter_texels(
        rec[0].reshape(-1), rec[1].reshape(-1, 3), h * w), None)
    return jobs


def main(argv=None) -> int:
    args = _args(argv)
    root = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 1
    import halogen_tpu_torch as ht
    from halogen_tpu_torch.integrator.camera import generate_rays
    from halogen_tpu_torch.integrator.trace import (
        _make_pool,
        _morton_pixel_order,
        _pool_bounce,
        _sampler_2d,
    )
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.kernels import traverse
    from halogen_tpu_torch.profile_frame import _self_device_us
    from halogen_tpu_torch.sampler import sobol as sob
    from halogen_tpu_torch.scene import cornell, meshes

    assert os.path.dirname(os.path.dirname(ht.__file__)) == root, ht.__file__
    for lib in mk.LIBRARIES:
        mk.load_library(lib)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    res = _resources(mk.BUILD_LOG)

    def rays(cam_kw, spp=32, size=512):
        cam = ht.make_camera(**cam_kw, device=dev)
        return (cam, *rays_at(cam, spp, size))

    def rays_at(cam, spp=32, size=512):
        st = ht.RenderSettings(width=size, height=size, samples_per_pixel=spp)
        perm, _ = _morton_pixel_order(size, size)
        pix = torch.from_numpy(perm[:262144].astype(np.int64)).to(dev)
        sidx = sob.sample_index(1, torch.zeros_like(pix), spp)
        seed = sob.pixel_seed(pix)
        o, d = generate_rays(cam, pix % size, pix // size, size, size,
                             st.filter_radius, sidx, seed, _sampler_2d(st))
        return o, d, sidx, seed

    cam_kw = dict(position=(0.0, 0.0, 3.2), target=(0.0, 0.0, 0.0),
                  fov_deg=40.0)
    dragon_kw = dict(position=(0.0, 1.5, 5.0), target=(0.0, -0.3, 0.0),
                     fov_deg=45.0)
    sky = ht.Envmap.gradient_sky()
    cam, o, d, sidx, seed = rays(cam_kw)
    dcam, o_d, d_d, sidx_d, seed_d = rays(dragon_kw)
    r_e = rays(dict(position=(0.0, 1.0, 6.0), target=(0.0, 0.5, 0.0),
                    fov_deg=40.0), spp=16, size=1024)
    spheres = cornell.material_demo_spheres().build(envmap=sky, device=dev)
    ct = torch.rand((o.shape[0], 3),
                    generator=torch.Generator().manual_seed(0)).to(dev)
    cornell_sc = cornell.cornell_box(glossy=True).build(device=dev)
    glass = cornell.glass_sphere_box().build(device=dev)
    dragon = meshes.glass_dragon_scene().build(device=dev)
    hero = meshes.dragons_hero_scene(1, tris=1280).build(envmap=sky,
                                                         device=dev)
    dragon_sky = meshes.glass_dragon_scene().build(envmap=sky, device=dev)
    st_a = ht.RenderSettings(max_bounces=6)
    st_g = ht.RenderSettings(max_bounces=8, max_transmission_bounces=8)
    st_g16 = st_g.replace(max_bounces=16, max_transmission_bounces=16)
    st_d = ht.RenderSettings(max_bounces=12)
    sky_kw = dict(use_envmap=True, env_mip_level=0)

    def fwd(sc, st, r):
        tab, et = mk._scene_tables(sc), mk.env_table(sc)
        # the light table, where the tree has light NEE, made once
        lt = ({"light_tab": mk.light_table(sc)}
              if st.light_importance_sampling else {})
        c, o_, d_, s_, e_ = r
        if args.no_refill:
            return lambda: mk._launch(sc, o_, d_, c.far, s_, e_, st, tab, et,
                                      refill=False, **lt)
        return lambda: mk.trace_fused_outputs(sc, o_, d_, c.far, s_, e_, st,
                                              tab, et, **lt)

    def bwd_at(sc, st, r):
        """The adjoint alone on rays r, with the sky's cotangents where the
        scene has a sky in use."""
        tab, et = mk._scene_tables(sc), mk.env_table(sc)
        c, o_, d_, s_, e_ = r
        n = o_.shape[0]
        g = torch.Generator().manual_seed(1)
        ct_ = torch.rand((n, 3), generator=g).to(dev)
        gsky = torch.rand((n, 4), generator=g).to(dev)
        env = adj.env_mode(sc, st)
        return lambda: adj._launch(sc, o_, d_, c.far, s_, e_, ct_, st, tab,
                                   gsky=gsky if env else None, env_tab=et)

    def empty_record(n, st, env_nee):
        """A record of n rays; with area-light NEE (a tree that records
        it) its light words too."""
        if st.light_importance_sampling:
            return mk.empty_record(n, st, env_nee, dev, True)
        return mk.empty_record(n, st, env_nee, dev)

    def sweep_at(sc, st, r, ct_=None):
        """The record route's sweep on rays r, the cotangents of bwd_at
        (or of the color alone, `ct_`, as bwd's), over the transcript a
        forward launch recorded on them once."""
        tab, et = mk._scene_tables(sc), mk.env_table(sc)
        c, o_, d_, s_, e_ = r
        n = o_.shape[0]
        g = torch.Generator().manual_seed(1)
        drawn = torch.rand((n, 3), generator=g).to(dev)  # gsky's draw follows
        ct_ = drawn if ct_ is None else ct_
        gsky = torch.rand((n, 4), generator=g).to(dev)
        env = adj.env_mode(sc, st)
        rec = empty_record(n, st, env == 2)
        lt = ({"light_tab": mk.light_table(sc)}
              if st.light_importance_sampling else {})
        mk.trace_fused_outputs(sc, o_, d_, c.far, s_, e_, st, tab, et,
                               record=rec, **lt)
        return lambda: adj._launch(sc, None, None, None, None, None, ct_, st,
                                   tab, gsky=gsky if env else None,
                                   env_tab=et, record=rec)

    def bwd(sc, st, route=None):
        tab = mk._scene_tables(sc)
        if route is None:
            return lambda: adj.trace_grad_fused_materials(
                sc, o, d, cam.far, sidx, seed, ct, st, tab)
        return lambda: adj._launch(sc, o, d, cam.far, sidx, seed, ct, st,
                                   tab, route=route)

    r_c, r_d = (cam, o, d, sidx, seed), (dcam, o_d, d_d, sidx_d, seed_d)
    far_d = dcam.far.expand(o_d.shape[0]).contiguous()
    pool = _pool_bounce(dragon, st_d, _make_pool(o_d, d_d, dcam.far, sidx_d,
                                                 seed_d, True), 0)
    o_b, d_b = pool.origin.contiguous(), pool.direction.contiguous()
    seed_b = torch.where(pool.active, far_d, -1.0)
    # name: (launch, a part of its profiler rows' keys: megakernel<...>
    # and megakernel_bvh<...> are the forward kernel's tiers)
    jobs = {
        "B1a": (fwd(cornell_sc, st_a, r_c), "megakernel"),
        "B2": (bwd(cornell_sc, st_a), "adjoint_kernel<"),
        "B1b": (fwd(glass, st_g, r_c), "megakernel"),
        "B2b": (bwd(glass, st_g), "adjoint_kernel<"),
        "B2b@16": (bwd(glass, st_g16), "adjoint_kernel<"),
        "B1c": (fwd(spheres, st_d.replace(max_bounces=4,
                                          env_importance_sampling=True,
                                          **sky_kw), r_e), "megakernel"),
        "B1b+d": (fwd(dragon, st_d, r_d), "megakernel"),
        "B1d": (fwd(hero, st_d.replace(max_bounces=4, **sky_kw), r_d),
                "megakernel"),
        "B1c+d": (fwd(hero, st_d.replace(max_bounces=4,
                                         env_importance_sampling=True,
                                         **sky_kw), r_d), "megakernel"),
        "B1b+c+d": (fwd(dragon_sky, st_d.replace(
            env_importance_sampling=True, **sky_kw), r_d), "megakernel"),
        "B3 camera": (lambda: traverse.traverse_world(dragon.wbvh, o_d, d_d,
                                                      far_d),
                      "traverse_kernel"),
        "B3 bounce": (lambda: traverse.traverse_world(dragon.wbvh, o_b, d_b,
                                                      seed_b),
                      "traverse_kernel"),
    }
    if hasattr(adj, "env_mode"):  # the BVH and sky variants, and the sky
        from halogen_tpu_torch.kernels import sky as sky_k
        from halogen_tpu_torch.scene.material import Material

        box = cornell.cornell_box(with_spheres=False)
        verts, faces = meshes.dragon_mesh(3)
        box.add_mesh(verts, faces, Material.metal((0.9, 0.6, 0.5),
                                                  roughness=0.4),
                     transform=meshes._scale_translate(0.55,
                                                       (0.0, -0.45, 0.0)))
        metal_dragon = box.build(device=dev)
        st_e = ht.RenderSettings(max_bounces=4, env_importance_sampling=True,
                                 **sky_kw)
        st_sky = st_e.replace(env_importance_sampling=False)
        jobs.update({
            "B2b+d": (bwd_at(dragon, st_d, r_d), "adjoint_kernel<"),
            "B2+d": (bwd_at(metal_dragon, st_d, r_d), "adjoint_kernel<"),
            "B2c+d": (bwd_at(hero, st_sky, r_d), "adjoint_kernel<"),
            "B2c+n+d": (bwd_at(hero, st_e, r_d), "adjoint_kernel<"),
            "B2c": (bwd_at(spheres, st_sky, r_e), "adjoint_kernel<"),
            "B2c+n": (bwd_at(spheres, st_e, r_e), "adjoint_kernel<"),
        })
        c_e, o_e, d_e, s_e, e_e = r_e
        out_e = mk.trace_fused_outputs(spheres, o_e, d_e, c_e.far, s_e, e_e,
                                       st_e)
        ct_e = torch.rand((o_e.shape[0], 3),
                          generator=torch.Generator().manual_seed(2)).to(dev)
        jobs["sky forward"] = (
            lambda: sky_k.sky_forward(spheres, st_e, out_e), "sky_forward")
        jobs["sky backward"] = (
            lambda: sky_k.sky_backward_full(spheres, st_e, out_e, ct_e),
            None)
        jobs.update(_sky_stages(sky_k, adj, mk, spheres, st_e, r_e, out_e,
                                ct_e))
    if hasattr(adj, "record_plan"):  # the record route, where it is
        rec_d = mk.empty_record(o_d.shape[0], st_d, False, dev)
        tab_d = mk._scene_tables(dragon)
        jobs.update({
            "B1b+d record": (lambda: mk.trace_fused_outputs(
                dragon, o_d, d_d, dcam.far, sidx_d, seed_d, st_d, tab_d,
                record=rec_d), "megakernel_bvh_record<"),
            "B2b+d sweep": (sweep_at(dragon, st_d, r_d), "adjoint_sweep<"),
            "B2+d sweep": (sweep_at(metal_dragon, st_d, r_d),
                           "adjoint_sweep<"),
            "B2c+d sweep": (sweep_at(hero, st_sky, r_d), "adjoint_sweep<"),
            "B2c+n+d sweep": (sweep_at(hero, st_e, r_d), "adjoint_sweep<"),
        })
    if hasattr(mk, "light_table"):  # area-light NEE (B1e), where it is
        st_l = st_d.replace(light_importance_sampling=True)
        st_al = st_a.replace(light_importance_sampling=True)
        orbs = cornell.glow_orbs().build(device=dev)
        sky_cornell = cornell.cornell_box(glossy=True).build(envmap=sky,
                                                             device=dev)
        glass_sky = cornell.glass_sphere_box().build(envmap=sky, device=dev)
        st_both = st_al.replace(env_importance_sampling=True, **sky_kw)
        jobs["B1e"] = (fwd(cornell_sc, st_al, r_c), "megakernel")
        jobs["B1a glow_orbs"] = (fwd(orbs, st_a, r_c), "megakernel")
        jobs["B1e glow_orbs"] = (fwd(orbs, st_al, r_c), "megakernel")
        jobs["B1b+e"] = (fwd(glass, st_g.replace(
            light_importance_sampling=True), r_c), "megakernel")
        jobs["B1c+e"] = (fwd(sky_cornell, st_both, r_c), "megakernel")
        jobs["B1b+c+e"] = (fwd(glass_sky, st_both.replace(
            max_bounces=8, max_transmission_bounces=8), r_c), "megakernel")
        jobs["B1b+e+d"] = (fwd(dragon, st_l, r_d), "megakernel")
        jobs["B1e+d"] = (fwd(metal_dragon, st_l, r_d), "megakernel")
        from halogen_tpu_torch.scene import testing_scene

        testing = testing_scene.testing_scene(False).build(device=dev)
        tcam = testing_scene.testing_scene_camera(device=dev)
        jobs["B1e+d testing"] = (fwd(testing, st_l.replace(max_bounces=4),
                                     (tcam, *rays_at(tcam))), "megakernel")
    if hasattr(mk, "light_probe"):  # the brute tier records; the probe
        def rec_fwd(sc, st, r):
            tab, et = mk._scene_tables(sc), mk.env_table(sc)
            lt = ({"light_tab": mk.light_table(sc)}
                  if st.light_importance_sampling else {})
            c, o_, d_, s_, e_ = r
            rec = empty_record(o_.shape[0], st, adj.env_mode(sc, st) == 2)
            return lambda: mk.trace_fused_outputs(sc, o_, d_, c.far, s_, e_,
                                                  st, tab, et, record=rec,
                                                  **lt)

        st_c = st_d.replace(max_bounces=4, env_importance_sampling=True,
                            **sky_kw)
        jobs.update({
            "B1a record": (rec_fwd(cornell_sc, st_a, r_c),
                           "megakernel_record<"),
            "B1b record": (rec_fwd(glass, st_g, r_c), "megakernel_record<"),
            "B1c record": (rec_fwd(spheres, st_c, r_e),
                           "megakernel_record<"),
            "B2 sweep": (sweep_at(cornell_sc, st_a, r_c, ct),
                         "adjoint_sweep<"),
            "B2b sweep": (sweep_at(glass, st_g, r_c, ct), "adjoint_sweep<"),
            "B2c sweep": (sweep_at(spheres, st_sky, r_e), "adjoint_sweep<"),
            "B2c+n sweep": (sweep_at(spheres, st_e, r_e), "adjoint_sweep<"),
        })
        if "lq" in mk.Record._fields:  # the light-NEE record (B2+l)
            jobs.update({
                "B1e record": (rec_fwd(cornell_sc, st_al, r_c),
                               "megakernel_light_record<"),
                "B1e+d record": (rec_fwd(metal_dragon, st_l, r_d),
                                 "megakernel_bvh_light_record<"),
                "B1b+e+d record": (rec_fwd(dragon, st_l, r_d),
                                   "megakernel_bvh_light_record<"),
                "B2+l sweep": (sweep_at(cornell_sc, st_al, r_c, ct),
                               "adjoint_sweep<"),
                "B2+l glow_orbs sweep": (sweep_at(orbs, st_al, r_c, ct),
                                         "adjoint_sweep<"),
                "B2+l+d sweep": (sweep_at(metal_dragon, st_l, r_d),
                                 "adjoint_sweep<"),
                "B2b+l+d sweep": (sweep_at(dragon, st_l, r_d),
                                  "adjoint_sweep<"),
            })
        tab_l, lt = mk._scene_tables(dragon), mk.light_table(dragon)
        # the modes by this tree's names (before the brute tier's probe the
        # kernel's walk was "any" and no test "no walk")
        named = {"closest only": "closest only", "kernel only": "any only",
                 "no test": "no walk"}
        for job, mode in named.items():
            mode = job if job in mk.PROBE_MODES else mode
            jobs[f"B1b+e+d probe: {job}"] = (
                lambda mode=mode: mk.light_probe(
                    dragon, o_d, d_d, dcam.far, sidx_d, seed_d, st_l, mode,
                    tab_l, lt), "megakernel_bvh_light_probe<")
    if hasattr(mk, "light_cull_reference"):  # the brute tier's probe
        c_, o_, d_, s_, e_ = r_c
        for name, sc in (("B1e", cornell_sc), ("B1e glow_orbs", orbs)):
            tab_b, lt_b = mk._scene_tables(sc), mk.light_table(sc)
            for mode in ("no test", "closest only", "kernel only"):
                jobs[f"{name} probe: {mode}"] = (
                    lambda sc=sc, mode=mode, tab_b=tab_b, lt_b=lt_b:
                    mk.light_probe(sc, o_, d_, c_.far, s_, e_, st_al, mode,
                                   tab_b, lt_b)[0], "megakernel_light_probe<")
    if hasattr(adj, "transcript_route"):  # the routes, where there are two
        for name, sc, st in (("B2", cornell_sc, st_a), ("B2b", glass, st_g),
                             ("B2b@16", glass, st_g16)):
            for route in ("shared", "global"):
                jobs[f"{name} {route}"] = (bwd(sc, st, route),
                                           "adjoint_kernel<")
    if args.only:
        jobs = {k: v for k, v in jobs.items() if k in args.only}

    def events_ms(fn, reps=10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, key, reps=10):
        # the mean over the launches the profiler recorded (it can drop
        # events); every job with a key launches its kernel once a call;
        # with key None, every device kernel of a call, per call, and the
        # split by kernel name
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if key is None:
            rows = [r for r in prof.key_averages() if _self_device_us(r) > 0]
            split = {}
            for r in rows:
                name = r.key.replace("(anonymous namespace)::", "").split(
                    "(")[0][:48]
                split[name] = split.get(name, 0.0) + (
                    _self_device_us(r) / 1e3 / reps)
            return sum(split.values()), split
        rows = [r for r in prof.key_averages() if key in r.key]
        count = sum(r.count for r in rows)
        if not count:  # it kept none of them
            return float("nan")
        return sum(_self_device_us(r) for r in rows) / 1e3 / count

    times = {}
    for name, (fn, key) in jobs.items():
        out = fn()
        torch.cuda.synchronize()
        digest = None
        if isinstance(out, torch.Tensor):
            digest = hashlib.sha256(
                out.detach().cpu().numpy().tobytes()).hexdigest()[:16]
        ev = [events_ms(fn), events_ms(fn)]
        dev_ms, split = device_ms(fn, key), None
        if key is None:
            dev_ms, split = dev_ms
        times[name] = {"events_ms": ev, "device_ms": dev_ms}
        if split is not None:
            times[name]["device_ms_by_kernel"] = split
        if digest is not None:
            times[name]["result_sha256"] = digest
        print(f"{name}: events {ev[0]:.4f}, {ev[1]:.4f} ms; device "
              f"{dev_ms:.4f} ms{'' if split is None else f' {split}'}"
              f"{'' if digest is None else f'; result {digest}'} | "
              f"{card}", flush=True)
    result = {"card": card, "tree": root, "no_refill": args.no_refill,
              "nvcc_flags": mk.NVCC_FLAGS,
              "build_seconds": mk.BUILD_SECONDS, "resources": res,
              "times": times}
    for k, v in res.items():
        print(f"  {k}: registers {v[0]}, spill-store bytes {v[1]}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
