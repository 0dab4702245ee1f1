#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit
(no phase is caught):
  1. require a CUDA device; print the card's name and power limit;
  2. build the three kernel libraries (the megakernel, its adjoint and
     the world-BVH traversal) from `halogen_tpu_torch/csrc/`, one nvcc
     process per source, in parallel;
  3. kernel vs its plain PyTorch version on the card (Cornell glossy,
     64x64 pixels x 4 spp lanes, 4 bounces; Sobol+RR, Sobol, PRNG+RR and
     per-type bounce limits): atol = rtol = 1e-4 per ray, at most 0.1% of
     rays outside;
  4. the two Cornell goldens of the JAX package (`tests/golden/`) rendered
     through the kernel, at `tests/test_golden.py`'s bounds;
  5. the kernel's and the plain version's time at the main path's launch
     shape (262144 rays, 6 bounces);
  6. the main path at `bench.py`'s configuration (Cornell glossy, 512x512,
     32 spp, 6 bounces, 262144-ray chunks): one warm-up frame and 4 timed
     frames through `render_frame`, with the kernel's launch count; one
     frame of the plain version, whose mean radiance must agree within 2%;
  7. adjoint kernel vs its plain PyTorch version on the card (phase 3's
     four cases, a cotangent from torch.Generator seed 0): per [K, 12]
     column |kernel - plain| <= 1e-3 * max |plain column| + 1e-6; two
     calls bitwise equal; the replay's color equal to the megakernel's
     bit for bit;
  8. the adjoint's and its plain version's time at the main path's launch
     shape (262144 rays, 6 bounces);
  9. forward plus backward at `bench.py`'s configuration (Cornell glossy,
     256x256, 256 spp, 6 bounces): one warm-up step and 2 timed steps of
     `render_loss_grad`, with both kernels' launch counts (64 + 64 per
     step); then, at 64x64 and 16 spp, its grads against the plain route
     (`Fused.OFF`) at phase 7's tolerance;
 10. the fitting loop as the JAX CLI's `fit` runs it (256x256, 16 spp, 6
     bounces, target at frame 0, albedo perturbed to clip(0.5 a + 0.2),
     20 steps of `fit_materials` at lr 5e-2 with a checkpoint): finite
     losses, and a lower image loss at a frame the fit never saw. The
     albedo's distance to the truth is printed, not asserted: the
     detached estimator's gradient uses the same samples as the image,
     and at 16 spp that bias moves the albedo away from the truth in the
     JAX package as well (PERF.md);
 11. the glass and sky variants vs their plain versions, 64x64 pixels x 4
     lanes: the glass-in-glass box at 8 bounces (medium stack) in four
     cases (Sobol+RR, Sobol, PRNG+RR, a transmission limit of 2), Cornell
     glossy under the gradient sky with the mip bias (deferred miss), and
     the material spheres and the glass box under the sky with env NEE at
     mip level 0:
     outputs 0-9 and the color after the sky pass at atol = rtol = 1e-4,
     at most 0.1% of rays outside; with env NEE the miss flag (output 11)
     at the same bound and the continuation pdf (output 10) at rtol 1e-2
     (a near-mirror glossy pdf, up to ~1e3, amplifies ulp-level direction
     differences);
 12. the `glass_box` and `envmap_nee` goldens rendered through the
     kernels, at `tests/test_golden.py`'s bounds;
 13. the registers and spill bytes of every variant, and their and their
     plain versions' times at the launch shape (262144 rays): B1a at 6
     bounces, the glass variant at 8, the env-NEE variant at 4;
 14. the forward paths at full size: the glass box (512x512, 32 spp, 8
     bounces, one warm-up and 4 timed frames) and the `envmap_1024` preset
     (material spheres under the sky, 1024x1024, 16 spp, 4 bounces, env
     NEE, mip level 0; one warm-up and 2 timed frames), each with its
     launch count and Mrays/s; then one 256x256 frame of each against the
     plain route, mean radiance within 2%;
 15. the glass adjoint: vs its plain version in phase 11's four glass
     cases (phase 7's tolerance), bitwise repeatable, its replay equal to
     the glass forward bit for bit; its time at the launch shape; the
     glass fwd+bwd step (`render_loss_grad`, 256x256, 256 spp, 8 bounces,
     64 + 64 launches per step) and its grads vs `Fused.OFF` at 64x64, 16
     spp; a backward on an envmap scene raises NotImplementedError;
 16. the world-BVH traversal kernel (B3) vs its plain version (a brute
     force over the same triangles) on the glass dragon's BVH (8,724
     triangles): 65536 rays, half camera rays and half numpy-seeded points
     and directions inside its box, seeds +inf, finite (0.2-3) and < 0:
     t, u and v at atol = rtol = 1e-5, the triangle equal except at ties
     (t within 1e-6), at most 0.1% of rays; then Intersector.PALLAS,
     TREELET, FLATLET and RAYLET (the routes of B3-B6) each on a 64x64
     lockstep frame (Fused.OFF, 12 bounces): the kernel's launch count
     moves (and stays at 0 under BRUTE), and the frame agrees with
     BRUTE's (phase 11's tolerance per pixel);
 17. the BVH-tier variants (B1d) vs their plain version (the lockstep
     with brute-force hits), 64x64 pixels x 4 lanes: the glass dragon at
     12 bounces in phase 11's four cases, a 1,280-triangle dragon under
     the sky with and without env NEE, and the glass dragon under the sky
     with env NEE, each at frames 1, 2 and 3, at phase 11's tolerance
     with the final direction and the continuation pdf held where and as
     the sky pass reads them: on rays that reached the sky (a killed
     ray's last direction and pdf are never read; through 12 bounces of
     curved glass the direction drifts by up to ~1e-2 from ulp-level
     differences), and the pdf through the balance-heuristic weight it
     gives the sky, at rtol 1e-2 (the pdf grows without bound toward the
     rim of a 0.05-roughness lobe's support and is 0 past it, so an ulp
     of direction moves it by far more than 1e-2 while its weight stays
     near 1); the color after the sky pass on every ray; the raw pdf's
     outside count and the unread rays' largest difference are printed;
 18. the `testing_active` and `testing_composite` goldens (77,364 and
     78,678 triangles) through B1d, at `tests/test_golden.py`'s bounds
     (MAE and worst pixel), against the world-space lockstep on the card
     (B3's hits): the frame's rays through B1d agree with the lockstep's
     on the same rays at phase 17's per-ray tolerance, and a pixel past
     the worst-pixel bound passes only where the lockstep's frame
     (`Fused.OFF`) is past it too and within 1e-4 of B1d's: the goldens
     were rendered by the JAX package's walk of each mesh's BVH in local
     space, and in `testing_active` one path meets a triangle at
     t = 1.03e-4, an ulp from HIT_EPS, where the two spaces round apart;
 19. times at the launch shape (262144 rays): B3 on the glass dragon's
     camera rays and on one bounce's rays, by CUDA events and profiler
     device time, with the triangle and box tests the walks made; each
     B1d variant (events and
     device time), with the work its rays need (from the lockstep on the
     same rays) and its bound; the plain versions at 16384 rays (a brute
     force over 8.7k triangles: not for speed);
 20. the glass dragon at `bench.py`'s configuration (512x512, 32 spp, 12
     bounces, 262144-ray chunks): one warm-up and 2 timed frames through
     `render_frame`, 32 B1d launches per frame, Mrays/s and the device's
     idle share (profiler); then one 256x256 frame through `Fused.OFF`
     (lockstep + B3 on the card), mean radiance within 2% of the kernel
     route's;
 21. the work each launch shape of B1a-c, B2 and B2b needs, for their
     bounds.
The last lines are a JSON record of every kernel (B1a-d, B2, B2b, B3, and
the routes B4-B6 that B3's kernel serves) with its launches on its main
path, error, times, plain time, bound and library call, the card's name
and power limit, and {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
CAM = dict(position=(0.0, 0.0, 3.2), target=(0.0, 0.0, 0.0), fov_deg=40.0)
# the envmap_nee golden's camera (scripts/gen_goldens.py:66-67)
SKY_CAM = dict(position=(0.0, 1.0, 6.0), target=(0.0, 0.5, 0.0),
               fov_deg=40.0)
PARITY_TOL = 1e-4
PDF_RTOL = 1e-2  # env NEE's continuation pdf at the miss (output 10)
PARITY_MAX_OUTSIDE = 1e-3  # share of rays
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6  # per column, of the column's max
DRAGON_CAM = dict(position=(0.0, 1.5, 5.0), target=(0.0, -0.3, 0.0),
                  fov_deg=45.0)  # bench.py's glass_dragon camera
# fp32 operations of one primitive test and of one shaded bounce, counted
# from csrc/geometry.cuh (triangle_hit, sphere_t), bvh_traverse.cuh
# (node_entry) and path_common.cuh (path_bounce; sinf, cosf, expf and
# sqrtf as ~20 each; the sampler's integer work is not counted)
OPS_TRI, OPS_SPHERE, OPS_BOX = 55, 55, 27
OPS_SHADE = 230  # an opaque hit: normals, draws, Fresnel, lobes, RR
OPS_GLASS = 50  # + the refraction branch and Beer-Lambert
OPS_NEE = 190  # + the env draw, two glossy pdfs and the MIS weight
OPS_ADJ = 100  # + the adjoint's reverse sweep of the bounce
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: fp32, HBM3


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _resources(log: str) -> dict:
    """Registers and spill-store bytes of every kernel variant, from
    nvcc's `-Xptxas -v` output: {name: (registers, spill bytes)}."""
    names = {"megakernelILb0ELb0ELb0E": "B1a", "megakernelILb1ELb0ELb0E": "B1b",
             "megakernelILb0ELb1ELb0E": "B1c", "megakernelILb1ELb1ELb0E": "B1b+c",
             "megakernelILb0ELb0ELb1E": "B1d", "megakernelILb1ELb0ELb1E": "B1b+d",
             "megakernelILb0ELb1ELb1E": "B1c+d",
             "megakernelILb1ELb1ELb1E": "B1b+c+d",
             "adjoint_kernelILb0E": "B2", "adjoint_kernelILb1E": "B2b",
             "traverse_kernel": "B3"}
    out, cur, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = next((v for k, v in names.items() if k in m.group(1)),
                       None)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), spill)
    return out


def _path_work(scene, o, d, far, sidx, seed, st) -> dict:
    """What the kernel's path needs on these rays, counted by the lockstep
    on the card with its closest hits brute-forced (or, for a BVH-tier
    scene, walked by B3, whose counters give the walk's tests): ray-bounce
    intersections, shaded bounces, env-NEE shadow rays (the lanes whose
    draw faces an opaque surface, as the kernel's), and the triangle, box
    and sphere tests. A shadow ray's walk is counted as a closest-hit walk,
    an upper bound on the kernel's any-hit walk."""
    import halogen_tpu_torch.integrator.trace as tr
    from halogen_tpu_torch.config import Intersector
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.kernels import traverse

    bvh, nee = mk.uses_bvh(scene), tr._use_nee(scene, st)
    w = dict(rays=0, shaded=0, shadow=0, tri=0, box=0)
    state = {"calls": 0}
    isect0, walk0 = tr.intersect_scene, traverse.traverse_world

    def walk(wbvh, origin, direction, seed_):
        out = walk0(wbvh, origin, direction, seed_)
        w["tri"] += int(out[5][state["mask"]].sum())
        w["box"] += int(out[6][state["mask"]].sum())
        return out

    def isect(sc, origin, direction, far_, settings):
        shadow = nee and state["calls"] % 2 == 1
        state["calls"] += 1
        if shadow:  # the lanes that cast one (trace._pool_bounce's cand)
            h = state["hit"]
            opaque = sc.materials.albedo[h.material, 3] >= 1.0
            mask = state["shaded"] & opaque & (
                (h.normal * direction).sum(dim=1) > 0.0)
        else:
            mask = far_ > 0.0
        state["mask"] = mask
        hit = isect0(sc, origin, direction, far_, settings)
        n = int(mask.sum())
        w["shadow" if shadow else "rays"] += n
        if not shadow:
            state["hit"], state["shaded"] = hit, mask & (hit.t < far_)
            w["shaded"] += int(state["shaded"].sum())
        if not bvh:
            w["tri"] += n * sc.num_triangles
        return hit

    kind = Intersector.PALLAS if bvh else Intersector.BRUTE
    tr.intersect_scene, traverse.traverse_world = isect, walk
    try:
        tr.trace_rays(scene, o, d, far.expand(o.shape[0]), sidx, seed,
                      st.replace(intersector=kind))
    finally:
        tr.intersect_scene, traverse.traverse_world = isect0, walk0
    w["sphere"] = (w["rays"] + w["shadow"]) * scene.num_spheres
    return w


def _bound(n_bytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the least time of the work on an H100 SXM,
    the larger of its bytes over 3.35 TB/s and its fp32 operations over
    67 TFLOP/s (the H100 SXM's peak memory rate and fp32 rate)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def _path_ops(w: dict, glass: bool, nee: bool, adjoint: bool = False):
    shade = (OPS_SHADE + (OPS_GLASS if glass else 0) + (OPS_NEE if nee
             else 0) + (OPS_ADJ if adjoint else 0))
    return (w["tri"] * OPS_TRI + w["box"] * OPS_BOX
            + w["sphere"] * OPS_SPHERE + w["shaded"] * shade)


def _table_bytes(tables) -> int:
    return sum(t.numel() * t.element_size() for t in tables
               if t is not None)


def _grad_compare(got, ref) -> tuple:
    """Per column: |got - ref| against GRAD_RTOL * max |ref column| +
    GRAD_ATOL. Returns (max abs diff, worst diff / bound)."""
    import numpy as np

    got, ref = got.detach().cpu().numpy(), ref.detach().cpu().numpy()
    got, ref = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    assert np.isfinite(got).all(), "gradient is not finite"
    bound = GRAD_RTOL * np.abs(ref).max(axis=0) + GRAD_ATOL
    diff = np.abs(got - ref)
    return float(diff.max()), float((diff / bound).max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    import numpy as np

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.diff import (
        fit_materials,
        render_loss,
        render_loss_grad,
    )
    from halogen_tpu_torch.integrator.camera import generate_rays
    from halogen_tpu_torch.integrator.trace import (
        _morton_pixel_order,
        _sampler_2d,
    )
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.sampler import sobol as sob
    from halogen_tpu_torch.scene import cornell

    dev = torch.device("cuda", 0)
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | device 0: {kind}", flush=True)

    # --- 2. build
    t0 = time.perf_counter()
    for lib in mk.LIBRARIES:
        mk.load_library(lib)
    build_s = time.perf_counter() - t0
    print(f"[2] {', '.join(mk.LIBRARIES)} built and loaded in {build_s:.2f}"
          f" s (parallel nvcc {mk.BUILD_SECONDS} s)", flush=True)
    for line in mk.BUILD_LOG.splitlines():
        if (line.startswith("[") or "registers" in line or "spill" in line
                or "smem" in line):
            print("    ptxas:", line.strip())

    scene = cornell.cornell_box(glossy=True).build(device=dev)
    cam = ht.make_camera(**CAM, device=dev)

    def rays(pix, lanes, spp, st, frame, camera=None):
        camera = cam if camera is None else camera
        pixb = pix.repeat_interleave(lanes)
        lane = torch.arange(lanes, device=dev).repeat(pix.shape[0])
        sidx = sob.sample_index(frame, lane, spp)
        seed = sob.pixel_seed(pixb)
        o, d = generate_rays(camera, pixb % st.width, pixb // st.width,
                             st.width, st.height, st.filter_radius, sidx,
                             seed, _sampler_2d(st))
        return o, d, sidx, seed

    def compare(got, ref):
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
        assert np.isfinite(got).all(), "kernel output is not finite"
        bad = (np.abs(got - ref) > PARITY_TOL + PARITY_TOL * np.abs(ref))
        return bad.any(axis=1).sum(), float(np.abs(got - ref).max())

    # --- 3. kernel vs plain on the card
    base = dict(width=64, height=64, samples_per_pixel=4, max_bounces=4)
    cases = {
        "sobol_rr": ht.RenderSettings(**base),
        "sobol_no_rr": ht.RenderSettings(**base, russian_roulette=False),
        "prng_rr": ht.RenderSettings(**base, sampler=ht.SamplerKind.PRNG),
        "bounce_limits": ht.RenderSettings(
            **{**base, "max_bounces": 6}, max_diffuse_bounces=1,
            max_glossy_bounces=2, russian_roulette=False),
    }
    parity = {}
    for name, st in cases.items():
        pix = torch.arange(st.num_pixels, device=dev)
        o, d, sidx, seed = rays(pix, 4, 4, st, 1)
        got = mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed, st)
        ref = mk.trace_color_fused_reference(scene, o, d, cam.far, sidx,
                                             seed, st)
        torch.cuda.synchronize()
        n_bad, max_color = compare(got[:, :3], ref[:, :3])
        n_bad_all, max_all = compare(got, ref)
        n = got.shape[0]
        parity[name] = max_color
        print(f"[3] parity {name}: {n} rays, color max |diff| {max_color:.3e},"
              f" {n_bad} rays outside {PARITY_TOL}; all 10 outputs max "
              f"{max_all:.3e}, {n_bad_all} rays outside", flush=True)
        assert n_bad <= PARITY_MAX_OUTSIDE * n, f"parity {name} failed"
        assert n_bad_all <= PARITY_MAX_OUTSIDE * n, f"parity {name} failed"

    # --- 4. goldens through the kernel
    goldens = {
        "cornell_diffuse": (
            cornell.cornell_box().build(device=dev), cam,
            ht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                              max_bounces=2, ray_chunk_size=4096)),
        "cornell_glossy_dof": (
            scene, ht.make_camera(**CAM, aperture_deg=2.0,
                                  focal_distance=3.2, device=dev),
            ht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                              max_bounces=4, ray_chunk_size=4096)),
    }
    for name, (sc, cm, st) in goldens.items():
        golden = np.load(ROOT / "tests" / "golden" / f"{name}.npz")["image"]
        before = mk.LAUNCHES
        # the README's entry point; its first frame is sample stream 1
        img = ht.Renderer(sc, cm, st).step()
        assert mk.LAUNCHES > before, f"{name} did not run the kernel"
        assert img.shape == golden.shape and np.isfinite(img).all()
        mae = float(np.abs(img - golden).mean())
        worst = float(np.abs(img - golden).max())
        print(f"[4] golden {name}: {mk.LAUNCHES - before} launches, MAE "
              f"{mae:.3e} (< 5e-3), worst pixel {worst:.3e} (< 0.15)",
              flush=True)
        assert mae < 5e-3 and worst < 0.15, f"golden {name} failed"

    # --- 5. kernel and plain version at the main path's launch shape
    st = ht.RenderSettings(width=512, height=512, samples_per_pixel=32,
                           max_bounces=6, ray_chunk_size=262144)
    perm, _ = _morton_pixel_order(st.width, st.height)
    pix = torch.from_numpy(perm.astype(np.int64)).to(dev)
    o, d, sidx, seed = rays(pix, 1, st.samples_per_pixel, st, 1)
    tables = mk._scene_tables(scene)
    kernel = lambda: mk.trace_fused_outputs(scene, o, d, cam.far, sidx, seed,
                                            st, tables)
    plain = lambda: mk.trace_color_fused_reference(scene, o, d, cam.far,
                                                   sidx, seed, st)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    n_bad, max_err = compare(got[:, :3], ref[:, :3])
    n = got.shape[0]
    assert n_bad <= PARITY_MAX_OUTSIDE * n, "main-shape parity failed"
    plain_ms = [_cuda_ms(plain, 1)]
    kernel_ms = [_cuda_ms(kernel, 10), _cuda_ms(kernel, 10)]
    plain_ms.append(_cuda_ms(plain, 1))
    k_ms, p_ms = float(np.mean(kernel_ms)), float(np.mean(plain_ms))
    print(f"[5] one launch of {n} rays, 6 bounces: kernel {kernel_ms} ms, "
          f"plain {plain_ms} ms; color max |diff| {max_err:.3e}, {n_bad} "
          f"rays outside {PARITY_TOL}", flush=True)

    # --- 6. the main path at bench.py's configuration
    mk.LAUNCHES = adj.LAUNCHES = 0
    ht.render_frame(scene, cam, st, 0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = [ht.render_frame(scene, cam, st, f + 1) for f in range(4)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = mk.LAUNCHES
    assert launches > 0, "the main path did not launch the kernel"
    assert adj.LAUNCHES == 0, "the forward path launched the adjoint"
    for img in frames:
        assert img.shape == (512, 512, 3)
        assert bool(torch.isfinite(img).all()), "main-path image not finite"
    mrays = st.samples_per_pixel * st.width * st.height * 4 / dt / 1e6

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_img = ht.render_frame(scene, cam, st.replace(fused=ht.Fused.OFF), 1)
    torch.cuda.synchronize()
    plain_frame_s = time.perf_counter() - t0
    m_kernel = float(frames[0].mean())
    m_plain = float(plain_img.mean())
    rel = abs(m_kernel - m_plain) / abs(m_plain)
    print(f"[6] main path {st.width}x{st.height} {st.samples_per_pixel} spp "
          f"{st.max_bounces} bounces: {launches} kernel "
          f"launches in 5 frames; 4 frames in {dt:.4f} s = {mrays:.3f} "
          f"Mrays/s; plain frame {plain_frame_s:.4f} s = "
          f"{st.samples_per_pixel * st.num_pixels / plain_frame_s / 1e6:.3f}"
          f" Mrays/s; mean radiance kernel {m_kernel:.6f} vs plain "
          f"{m_plain:.6f} (rel {rel:.2e}, < 2e-2) | {card}", flush=True)
    assert rel < 2e-2, "main-path mean radiance disagrees with plain"

    # --- 7. adjoint kernel vs plain on the card
    adj_parity = {}
    for name, st7 in cases.items():
        pix = torch.arange(st7.num_pixels, device=dev)
        o7, d7, sidx7, seed7 = rays(pix, 4, 4, st7, 1)
        ct7 = torch.rand((o7.shape[0], 3),
                         generator=torch.Generator().manual_seed(0)).to(dev)
        replay = torch.empty_like(o7)
        got = adj._launch(scene, o7, d7, cam.far, sidx7, seed7, ct7, st7,
                          None, replay)
        again = adj.trace_grad_fused_materials(scene, o7, d7, cam.far, sidx7,
                                               seed7, ct7, st7)
        fwd = mk.trace_color_fused(scene, o7, d7, cam.far, sidx7, seed7, st7)
        ref = adj.trace_grad_fused_materials_reference(
            scene, o7, d7, cam.far, sidx7, seed7, ct7, st7)
        torch.cuda.synchronize()
        max_diff, ratio = _grad_compare(got, ref)
        adj_parity[name] = max_diff
        repeat = torch.equal(got, again)
        replay_ok = torch.equal(replay, fwd)
        print(f"[7] adjoint {name}: {o7.shape[0]} rays, [K, 12] max |diff| "
              f"{max_diff:.3e}, worst diff/bound {ratio:.3e} (<= 1); "
              f"bitwise repeatable {repeat}; replay color == forward "
              f"{replay_ok}", flush=True)
        assert ratio <= 1.0, f"adjoint parity {name} failed"
        assert repeat, f"adjoint {name} is not bitwise repeatable"
        assert replay_ok, f"adjoint {name} replayed another path"

    # --- 8. adjoint and plain version at the main path's launch shape
    ct = torch.rand((n, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    adj_kernel = lambda: adj.trace_grad_fused_materials(
        scene, o, d, cam.far, sidx, seed, ct, st, tables)
    adj_plain = lambda: adj.trace_grad_fused_materials_reference(
        scene, o, d, cam.far, sidx, seed, ct, st)
    got, ref = adj_kernel(), adj_plain()
    torch.cuda.synchronize()
    adj_err, adj_ratio = _grad_compare(got, ref)
    assert adj_ratio <= 1.0, "adjoint main-shape parity failed"
    adj_plain_ms = [_cuda_ms(adj_plain, 1)]
    adj_ms = [_cuda_ms(adj_kernel, 10), _cuda_ms(adj_kernel, 10)]
    adj_plain_ms.append(_cuda_ms(adj_plain, 1))
    a_ms, ap_ms = float(np.mean(adj_ms)), float(np.mean(adj_plain_ms))
    print(f"[8] adjoint, one launch of {n} rays, 6 bounces: kernel {adj_ms}"
          f" ms, plain {adj_plain_ms} ms; [K, 12] max |diff| {adj_err:.3e},"
          f" worst diff/bound {adj_ratio:.3e}", flush=True)

    # --- 9. forward plus backward at bench.py's configuration
    st9 = ht.RenderSettings(width=256, height=256, samples_per_pixel=256,
                            max_bounces=6, ray_chunk_size=262144)
    params = {"materials": scene.materials}
    zeros = torch.zeros((256, 256, 3), device=dev)
    mk.LAUNCHES = adj.LAUNCHES = 0
    render_loss_grad(params, scene, cam, st9, zeros, 0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = [render_loss_grad(params, scene, cam, st9, zeros, f)
             for f in (1, 2)]
    torch.cuda.synchronize()
    dt9 = time.perf_counter() - t0
    fb_launches = (mk.LAUNCHES, adj.LAUNCHES)
    assert fb_launches == (3 * 64, 3 * 64), fb_launches
    for loss, grads in steps:
        assert bool(torch.isfinite(loss)), "fwd+bwd loss not finite"
        for f in dataclasses.fields(grads["materials"]):
            g = getattr(grads["materials"], f.name)
            assert bool(torch.isfinite(g.float()).all()), f.name
    fb_mrays = st9.samples_per_pixel * st9.num_pixels * 2 / dt9 / 1e6
    print(f"[9] fwd+bwd {st9.width}x{st9.height} {st9.samples_per_pixel} spp"
          f" {st9.max_bounces} bounces: launches (megakernel, adjoint) "
          f"{fb_launches} in 3 steps; 2 steps in {dt9:.4f} s = "
          f"{fb_mrays:.3f} Mrays/s (fwd+bwd) | {card}", flush=True)
    st9s = st9.replace(width=64, height=64, samples_per_pixel=16)
    zeros_s = torch.zeros((64, 64, 3), device=dev)
    _, g_k = render_loss_grad(params, scene, cam, st9s, zeros_s, 1)
    _, g_p = render_loss_grad(params, scene, cam,
                              st9s.replace(fused=ht.Fused.OFF), zeros_s, 1)
    fb_err = {}
    for f in ("albedo", "specular", "metallic", "roughness", "emissive",
              "ior", "absorption"):
        fb_err[f], ratio = _grad_compare(getattr(g_k["materials"], f),
                                         getattr(g_p["materials"], f))
        assert ratio <= 1.0, f"render_loss_grad {f} disagrees with plain"
    print(f"[9] render_loss_grad 64x64 16 spp, kernels vs Fused.OFF, max "
          f"|diff| per field {fb_err}", flush=True)

    # --- 10. the fitting loop
    st10 = ht.RenderSettings(width=256, height=256, samples_per_pixel=16,
                             max_bounces=6, ray_chunk_size=262144)
    target = ht.render_frame(scene, cam, st10, 0)
    true = scene.materials
    pert = dataclasses.replace(
        true, albedo=torch.clamp(true.albedo * 0.5 + 0.2, 0.0, 1.0))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "fit.npz")
        torch.cuda.synchronize()
        marks = [time.perf_counter()]  # each step ends in float(loss)
        fitted, losses = fit_materials(
            dataclasses.replace(scene, materials=pert), cam, st10, target,
            steps=20, lr=5e-2, checkpoint_path=ckpt, checkpoint_every=10,
            callback=lambda i, p, l: marks.append(time.perf_counter()))
        assert int(np.load(ckpt)["step"]) == 20, "no fit checkpoint"
    step_ms = np.diff(marks) * 1e3
    fit_s = float(np.median(step_ms)) / 1e3
    err = lambda m: float((m.albedo[:, :3] - true.albedo[:, :3]).abs().mean())
    err0, err1 = err(pert), err(fitted["materials"])
    # the image loss at 4 frames the fit never saw, the same frames for
    # each table: the fit must lower it
    held = {name: float(np.mean([
                float(render_loss({"materials": m}, scene, cam, st10,
                                  target, f)) for f in range(1000, 1004)]))
            for name, m in (("perturbed", pert),
                            ("fitted", fitted["materials"]),
                            ("true", true))}
    print(f"[10] fit 20 steps: loss {losses[0]:.6e} -> {losses[-1]:.6e}; "
          f"held-out loss {held}; mean |albedo - truth| {err0:.4f} -> "
          f"{err1:.4f}; steps {step_ms.round(1).tolist()} ms, median "
          f"{fit_s:.4f} s", flush=True)
    assert np.isfinite(losses).all(), "fit losses not finite"
    assert held["fitted"] < held["perturbed"], "the fit did not lower the loss"

    # --- 11. the glass and sky variants vs plain on the card
    from halogen_tpu_torch.integrator.trace import deferred_sky
    from halogen_tpu_torch.scene.envmap import Envmap

    sky = Envmap.gradient_sky()
    glass = cornell.glass_sphere_box().build(device=dev)
    sky_cornell = cornell.cornell_box(glossy=True).build(envmap=sky,
                                                         device=dev)
    spheres = cornell.material_demo_spheres().build(envmap=sky, device=dev)
    glass_sky = cornell.glass_sphere_box().build(envmap=sky, device=dev)
    sky_cam = ht.make_camera(**SKY_CAM, device=dev)
    gbase = dict(width=64, height=64, samples_per_pixel=4, max_bounces=8,
                 max_transmission_bounces=8)
    glass_cases = {
        "glass_sobol_rr": ht.RenderSettings(**gbase),
        "glass_sobol_no_rr": ht.RenderSettings(**gbase,
                                               russian_roulette=False),
        "glass_prng_rr": ht.RenderSettings(**gbase,
                                           sampler=ht.SamplerKind.PRNG),
        "glass_transmission_2": ht.RenderSettings(
            **{**gbase, "max_transmission_bounces": 2}),
    }
    sky_cases = {
        "sky_cornell": (sky_cornell, cam, ht.RenderSettings(
            width=64, height=64, samples_per_pixel=4, max_bounces=4,
            use_envmap=True)),
        "sky_spheres_nee": (spheres, sky_cam, ht.RenderSettings(
            width=64, height=64, samples_per_pixel=4, max_bounces=4,
            use_envmap=True, env_importance_sampling=True, env_mip_level=0)),
        # the stack and env NEE together (variant B1b+c)
        "sky_glass_nee": (glass_sky, cam, ht.RenderSettings(
            **gbase, use_envmap=True, env_importance_sampling=True,
            env_mip_level=0)),
    }
    cases11 = {**{k: (glass, cam, v) for k, v in glass_cases.items()},
               **sky_cases}
    parity11 = {}
    for name, (sc, cm, st11) in cases11.items():
        pix = torch.arange(st11.num_pixels, device=dev)
        o11, d11, sidx11, seed11 = rays(pix, 4, 4, st11, 1, cm)
        got = mk.trace_fused_outputs(sc, o11, d11, cm.far, sidx11, seed11,
                                     st11)
        ref = mk.trace_color_fused_reference(sc, o11, d11, cm.far, sidx11,
                                             seed11, st11)
        col = mk.trace_color_fused(sc, o11, d11, cm.far, sidx11, seed11,
                                   st11)
        ref_col = deferred_sky(sc, st11, ref)
        torch.cuda.synchronize()
        n11 = got.shape[0]
        keep = [c for c in range(got.shape[1]) if c != 10]
        n_bad, max_out = compare(got[:, keep], ref[:, keep])
        n_bad_col, max_col = compare(col, ref_col)
        msg = ""
        if got.shape[1] > 10:
            pdf, pdf_ref = got[:, 10].cpu().numpy(), ref[:, 10].cpu().numpy()
            bad_pdf = int((np.abs(pdf - pdf_ref) > PARITY_TOL
                           + PDF_RTOL * np.abs(pdf_ref)).sum())
            rel_pdf = float((np.abs(pdf - pdf_ref)
                             / np.maximum(np.abs(pdf_ref), 1e-6)).max())
            msg = (f"; output 10 (continuation pdf) max rel diff "
                   f"{rel_pdf:.3e}, {bad_pdf} rays outside rtol {PDF_RTOL};"
                   f" NEE-covered misses {int((got[:, 11] > 0.5).sum())}")
            assert bad_pdf <= PARITY_MAX_OUTSIDE * n11, f"{name} pdf"
        parity11[name] = max(max_out, max_col)
        print(f"[11] {name}: {n11} rays, {got.shape[1]} outputs; outputs "
              f"max |diff| {max_out:.3e}, {n_bad} rays outside {PARITY_TOL};"
              f" color after the sky max |diff| {max_col:.3e}, {n_bad_col} "
              f"rays outside{msg}", flush=True)
        assert n_bad <= PARITY_MAX_OUTSIDE * n11, f"parity {name} failed"
        assert n_bad_col <= PARITY_MAX_OUTSIDE * n11, f"color {name} failed"
        assert np.isfinite(col.cpu().numpy()).all()

    # --- 12. the glass_box and envmap_nee goldens through the kernels
    goldens12 = {
        "glass_box": (glass, cam, ht.RenderSettings(
            width=64, height=64, samples_per_pixel=8, max_bounces=8,
            max_transmission_bounces=8, ray_chunk_size=4096)),
        "envmap_nee": (spheres, sky_cam, ht.RenderSettings(
            width=64, height=64, samples_per_pixel=8, max_bounces=4,
            use_envmap=True, env_importance_sampling=True,
            ray_chunk_size=4096)),
    }
    for name, (sc, cm, st12) in goldens12.items():
        golden = np.load(ROOT / "tests" / "golden" / f"{name}.npz")["image"]
        before = mk.LAUNCHES
        img = ht.Renderer(sc, cm, st12).step()
        assert mk.LAUNCHES > before, f"{name} did not run the kernel"
        assert img.shape == golden.shape and np.isfinite(img).all()
        mae = float(np.abs(img - golden).mean())
        worst = float(np.abs(img - golden).max())
        print(f"[12] golden {name}: {mk.LAUNCHES - before} launches, MAE "
              f"{mae:.3e} (< 5e-3), worst pixel {worst:.3e} (< 0.15)",
              flush=True)
        assert mae < 5e-3 and worst < 0.15, f"golden {name} failed"

    # --- 13. registers, spills and times at the launch shape
    res = _resources(mk.BUILD_LOG)
    print(f"[13] registers, spill-store bytes per variant: {res}",
          flush=True)
    assert set(res) == {"B1a", "B1b", "B1c", "B1b+c", "B1d", "B1b+d",
                        "B1c+d", "B1b+c+d", "B2", "B2b", "B3"}, res
    st_g = ht.RenderSettings(width=512, height=512, samples_per_pixel=32,
                             max_bounces=8, max_transmission_bounces=8,
                             ray_chunk_size=262144)
    pix_g = torch.from_numpy(perm.astype(np.int64)).to(dev)  # 512x512
    o_g, d_g, sidx_g, seed_g = rays(pix_g, 1, 32, st_g, 1)
    st_e = ht.RenderSettings(width=1024, height=1024, samples_per_pixel=16,
                             max_bounces=4, use_envmap=True,
                             env_importance_sampling=True, env_mip_level=0,
                             ray_chunk_size=262144)
    perm_e, _ = _morton_pixel_order(1024, 1024)
    pix_e = torch.from_numpy(perm_e[:262144].astype(np.int64)).to(dev)
    o_e, d_e, sidx_e, seed_e = rays(pix_e, 1, 16, st_e, 1, sky_cam)
    env_tab = mk.env_table(spheres)
    st_a = ht.RenderSettings(width=512, height=512, samples_per_pixel=32,
                             max_bounces=6, ray_chunk_size=262144)
    shapes13 = {  # phase 5's rays for B1a
        "B1a": (scene, cam, st_a, o, d, sidx, seed, None),
        "B1b": (glass, cam, st_g, o_g, d_g, sidx_g, seed_g, None),
        "B1c": (spheres, sky_cam, st_e, o_e, d_e, sidx_e, seed_e, env_tab),
    }
    times13, err13 = {}, {}
    for name, (sc, cm, st13, o13, d13, s13, e13, et) in shapes13.items():
        tab13 = mk._scene_tables(sc)
        kernel = lambda: mk.trace_fused_outputs(sc, o13, d13, cm.far, s13,
                                                e13, st13, tab13, et)
        plain = lambda: mk.trace_color_fused_reference(sc, o13, d13, cm.far,
                                                       s13, e13, st13)
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        n_bad, err13[name] = compare(got[:, :10], ref[:, :10])
        assert n_bad <= PARITY_MAX_OUTSIDE * got.shape[0], name
        p_ms = [_cuda_ms(plain, 1)]
        k_ms = [_cuda_ms(kernel, 10), _cuda_ms(kernel, 10)]
        p_ms.append(_cuda_ms(plain, 1))
        times13[name] = (k_ms, p_ms)
        print(f"[13] {name}: one launch of {got.shape[0]} rays, "
              f"{st13.max_bounces} bounces: kernel {k_ms} ms, plain {p_ms} "
              f"ms;"
              f" outputs 0-9 max |diff| {err13[name]:.3e}, {n_bad} rays "
              f"outside {PARITY_TOL} | {card}", flush=True)

    # --- 14. the glass and envmap_1024 forward paths at full size
    paths14 = {"glass": (glass, cam, st_g, 4),
               "envmap_1024": (spheres, sky_cam, st_e, 2)}
    main14 = {}
    for name, (sc, cm, st14, n_frames) in paths14.items():
        mk.LAUNCHES = adj.LAUNCHES = 0
        ht.render_frame(sc, cm, st14, 0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames14 = [ht.render_frame(sc, cm, st14, f + 1)
                    for f in range(n_frames)]
        torch.cuda.synchronize()
        dt14 = time.perf_counter() - t0
        launches14 = mk.LAUNCHES
        assert launches14 > 0, f"the {name} path did not launch the kernel"
        assert adj.LAUNCHES == 0
        for img in frames14:
            assert img.shape == (st14.height, st14.width, 3)
            assert bool(torch.isfinite(img).all()), f"{name} not finite"
        mr14 = (st14.samples_per_pixel * st14.num_pixels * n_frames / dt14
                / 1e6)
        small = st14.replace(width=256, height=256)
        k_img = ht.render_frame(sc, cm, small, 1)
        p_img = ht.render_frame(sc, cm, small.replace(fused=ht.Fused.OFF), 1)
        rel14 = abs(float(k_img.mean()) - float(p_img.mean())) / abs(
            float(p_img.mean()))
        main14[name] = (launches14, mr14, dt14 / n_frames, rel14)
        print(f"[14] {name} {st14.width}x{st14.height} "
              f"{st14.samples_per_pixel} spp {st14.max_bounces} bounces: "
              f"{launches14} kernel launches in "
              f"{n_frames + 1} frames; {n_frames} frames in {dt14:.4f} s = "
              f"{mr14:.3f} Mrays/s; 256x256 mean radiance kernel vs plain "
              f"rel {rel14:.2e} (< 2e-2) | {card}", flush=True)
        assert rel14 < 2e-2, f"{name} mean radiance disagrees with plain"

    # --- 15. the glass adjoint (B2b)
    adj15 = {}
    for name, st15 in glass_cases.items():
        pix = torch.arange(st15.num_pixels, device=dev)
        o15, d15, sidx15, seed15 = rays(pix, 4, 4, st15, 1)
        ct15 = torch.rand((o15.shape[0], 3),
                          generator=torch.Generator().manual_seed(0)).to(dev)
        replay = torch.empty_like(o15)
        got = adj._launch(glass, o15, d15, cam.far, sidx15, seed15, ct15,
                          st15, None, replay)
        again = adj.trace_grad_fused_materials(glass, o15, d15, cam.far,
                                               sidx15, seed15, ct15, st15)
        fwd = mk.trace_color_fused(glass, o15, d15, cam.far, sidx15, seed15,
                                   st15)
        ref = adj.trace_grad_fused_materials_reference(
            glass, o15, d15, cam.far, sidx15, seed15, ct15, st15)
        torch.cuda.synchronize()
        max_diff, ratio = _grad_compare(got, ref)
        adj15[name] = max_diff
        repeat, replay_ok = torch.equal(got, again), torch.equal(replay, fwd)
        print(f"[15] adjoint {name}: {o15.shape[0]} rays, [K, 12] max |diff|"
              f" {max_diff:.3e}, worst diff/bound {ratio:.3e} (<= 1); "
              f"absorption column max {float(ref[:, 9:].abs().max()):.3e};"
              f" bitwise repeatable {repeat}; replay color == forward "
              f"{replay_ok}", flush=True)
        assert ratio <= 1.0, f"adjoint parity {name} failed"
        assert repeat, f"adjoint {name} is not bitwise repeatable"
        assert replay_ok, f"adjoint {name} replayed another path"

    ct_g = torch.rand((o_g.shape[0], 3),
                      generator=torch.Generator().manual_seed(0)).to(dev)
    tab_g = mk._scene_tables(glass)
    b2b_kernel = lambda: adj.trace_grad_fused_materials(
        glass, o_g, d_g, cam.far, sidx_g, seed_g, ct_g, st_g, tab_g)
    b2b_plain = lambda: adj.trace_grad_fused_materials_reference(
        glass, o_g, d_g, cam.far, sidx_g, seed_g, ct_g, st_g)
    got, ref = b2b_kernel(), b2b_plain()
    torch.cuda.synchronize()
    b2b_err, b2b_ratio = _grad_compare(got, ref)
    assert b2b_ratio <= 1.0, "glass adjoint main-shape parity failed"
    b2b_p = [_cuda_ms(b2b_plain, 1)]
    b2b_k = [_cuda_ms(b2b_kernel, 10), _cuda_ms(b2b_kernel, 10)]
    b2b_p.append(_cuda_ms(b2b_plain, 1))
    print(f"[15] glass adjoint, one launch of {o_g.shape[0]} rays, 8 "
          f"bounces: kernel {b2b_k} ms, plain {b2b_p} ms; [K, 12] max "
          f"|diff| {b2b_err:.3e}, worst diff/bound {b2b_ratio:.3e} | {card}",
          flush=True)

    st15 = ht.RenderSettings(width=256, height=256, samples_per_pixel=256,
                             max_bounces=8, max_transmission_bounces=8,
                             ray_chunk_size=262144)
    params15 = {"materials": glass.materials}
    zeros15 = torch.zeros((256, 256, 3), device=dev)
    mk.LAUNCHES = adj.LAUNCHES = 0
    render_loss_grad(params15, glass, cam, st15, zeros15, 0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps15 = [render_loss_grad(params15, glass, cam, st15, zeros15, f)
               for f in (1, 2)]
    torch.cuda.synchronize()
    dt15 = time.perf_counter() - t0
    fb15 = (mk.LAUNCHES, adj.LAUNCHES)
    assert fb15 == (3 * 64, 3 * 64), fb15
    for loss, grads in steps15:
        assert bool(torch.isfinite(loss)), "glass fwd+bwd loss not finite"
        for f in dataclasses.fields(grads["materials"]):
            g = getattr(grads["materials"], f.name)
            assert bool(torch.isfinite(g.float()).all()), f.name
    fb15_mrays = st15.samples_per_pixel * st15.num_pixels * 2 / dt15 / 1e6
    print(f"[15] glass fwd+bwd {st15.width}x{st15.height} "
          f"{st15.samples_per_pixel} spp {st15.max_bounces} bounces: "
          f"launches (megakernel, adjoint) {fb15} in 3 steps; 2 steps in "
          f"{dt15:.4f} s = {fb15_mrays:.3f} Mrays/s (fwd+bwd) | {card}",
          flush=True)
    st15s = st15.replace(width=64, height=64, samples_per_pixel=16)
    zeros15s = torch.zeros((64, 64, 3), device=dev)
    _, g_k = render_loss_grad(params15, glass, cam, st15s, zeros15s, 1)
    _, g_p = render_loss_grad(params15, glass, cam,
                              st15s.replace(fused=ht.Fused.OFF), zeros15s, 1)
    fb15_err = {}
    for f in ("albedo", "specular", "metallic", "roughness", "emissive",
              "ior", "absorption"):
        fb15_err[f], ratio = _grad_compare(getattr(g_k["materials"], f),
                                           getattr(g_p["materials"], f))
        assert ratio <= 1.0, f"glass render_loss_grad {f} disagrees"
    print(f"[15] glass render_loss_grad 64x64 16 spp, kernels vs Fused.OFF, "
          f"max |diff| per field {fb15_err}", flush=True)
    st_sky = ht.RenderSettings(width=8, height=8, samples_per_pixel=2,
                               max_bounces=2, use_envmap=True)
    try:
        render_loss_grad({"materials": sky_cornell.materials}, sky_cornell,
                         cam, st_sky, torch.zeros((8, 8, 3), device=dev), 1)
    except NotImplementedError as e:
        print(f"[15] envmap backward raises NotImplementedError: {e}",
              flush=True)
    else:
        raise AssertionError("an envmap backward did not raise")

    # --- 16. B3 against its plain version, and the four world routes
    import halogen_tpu_torch.integrator.trace as tr
    from halogen_tpu_torch.integrator.trace import (
        _make_pool,
        _pool_bounce,
        env_mis_weight,
    )
    from halogen_tpu_torch.kernels import traverse
    from halogen_tpu_torch.profile_frame import _self_device_us
    from halogen_tpu_torch.scene import meshes, testing_scene

    dragon = meshes.glass_dragon_scene().build(device=dev)
    dcam = ht.make_camera(**DRAGON_CAM, device=dev)
    wb = dragon.wbvh
    st_d = ht.RenderSettings(width=512, height=512, samples_per_pixel=32,
                             max_bounces=12, ray_chunk_size=262144)
    o_cam, d_cam, sidx_cam, seed_cam = rays(pix_g, 1, 32, st_d, 1, dcam)
    rng = np.random.default_rng(0)
    half = 32768
    lo, hi = (wb.nodes[0, a:a + 3].cpu().numpy() for a in (0, 3))
    o_r = (lo + rng.random((half, 3)) * (hi - lo)).astype(np.float32)
    d_r = rng.normal(size=(half, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    o16 = torch.cat([o_cam[:half], torch.from_numpy(o_r).to(dev)])
    d16 = torch.cat([d_cam[:half], torch.from_numpy(d_r).to(dev)])
    kinds = rng.integers(0, 5, 2 * half)  # 2/5 inf, 2/5 finite, 1/5 < 0
    s16 = np.where(kinds < 2, np.inf, np.where(
        kinds < 4, rng.uniform(0.2, 3.0, 2 * half), -1.0)).astype(np.float32)
    s16 = torch.from_numpy(s16).to(dev)
    got = [x.cpu().numpy() for x in traverse.traverse_world(wb, o16, d16,
                                                            s16)]
    ref = [x.cpu().numpy() for x in traverse.traverse_world_reference(
        wb, o16, d16, s16)]
    n16 = o16.shape[0]
    assert np.array_equal(np.isinf(got[0]), np.isinf(ref[0])), "B3 hits"
    hit = np.isfinite(ref[0])
    assert not hit[s16.cpu().numpy() < 0].any(), "a negative seed hit"
    other = hit & (got[1] != ref[1])
    same = hit & ~other
    t_err = float(np.abs(got[0][hit] - ref[0][hit]).max())
    uv_err = float(max(np.abs(got[i][same] - ref[i][same]).max()
                       for i in (2, 3)))
    assert np.allclose(got[0][hit], ref[0][hit], atol=PARITY_TOL / 10,
                       rtol=PARITY_TOL / 10), "B3 t"
    for i in (2, 3):
        assert np.allclose(got[i][same], ref[i][same], atol=PARITY_TOL / 10,
                           rtol=PARITY_TOL / 10), "B3 u, v"
    ties = np.abs(got[0][other] - ref[0][other]) <= 1e-6
    assert ties.all() and other.sum() <= PARITY_MAX_OUTSIDE * n16, "B3 tri"
    b3_err = max(t_err, uv_err)
    print(f"[16] B3 vs plain, glass dragon ({wb.num_nodes} nodes, "
          f"{dragon.num_triangles} triangles): {n16} rays, {int(hit.sum())}"
          f" hits; t max |diff| {t_err:.3e}, u/v {uv_err:.3e} (<= 1e-5); "
          f"{int(other.sum())} other triangles, all ties within 1e-6; mean "
          f"tests per walked ray: {got[5][got[5] > 0].mean():.1f} triangles,"
          f" {got[6][got[5] > 0].mean():.1f} boxes", flush=True)

    st16 = ht.RenderSettings(width=64, height=64, samples_per_pixel=2,
                             max_bounces=12, fused=ht.Fused.OFF,
                             ray_chunk_size=8192)
    traverse.LAUNCHES = 0
    brute16 = ht.render_frame(dragon, dcam, st16.replace(
        intersector=ht.Intersector.BRUTE), 1).cpu().numpy()
    routes16 = {}
    assert traverse.LAUNCHES == 0, "BRUTE launched the traversal kernel"
    for route in ("PALLAS", "TREELET", "FLATLET", "RAYLET"):
        traverse.LAUNCHES = 0
        img = ht.render_frame(dragon, dcam, st16.replace(
            intersector=ht.Intersector[route]), 1).cpu().numpy()
        assert traverse.LAUNCHES > 0, route
        bad = (np.abs(img - brute16) > PARITY_TOL + PARITY_TOL
               * np.abs(brute16)).any(axis=-1)
        routes16[route] = (traverse.LAUNCHES,
                           float(np.abs(img - brute16).max()))
        print(f"[16] Intersector.{route}: {routes16[route][0]} launches of "
              f"the traversal kernel in a 64x64 lockstep frame, 12 bounces; vs "
              f"BRUTE max |diff| {routes16[route][1]:.3e}, {int(bad.sum())} "
              f"pixels outside {PARITY_TOL}", flush=True)
        assert bad.sum() <= PARITY_MAX_OUTSIDE * bad.size, route

    # --- 17. the BVH-tier variants (B1d) vs plain
    sky_hero = meshes.dragons_hero_scene(1, tris=1280).build(envmap=sky,
                                                             device=dev)
    dragon_sky = meshes.glass_dragon_scene().build(envmap=sky, device=dev)
    dbase = dict(width=64, height=64, samples_per_pixel=4, max_bounces=12)
    sbase = dict(width=64, height=64, samples_per_pixel=4, max_bounces=4,
                 use_envmap=True, env_mip_level=0)
    cases17 = {
        "dragon_sobol_rr": (dragon, ht.RenderSettings(**dbase)),
        "dragon_sobol_no_rr": (dragon, ht.RenderSettings(
            **dbase, russian_roulette=False)),
        "dragon_prng_rr": (dragon, ht.RenderSettings(
            **dbase, sampler=ht.SamplerKind.PRNG)),
        "dragon_transmission_2": (dragon, ht.RenderSettings(
            **dbase, max_transmission_bounces=2)),
        "hero_sky": (sky_hero, ht.RenderSettings(**sbase)),
        "hero_sky_nee": (sky_hero, ht.RenderSettings(
            **sbase, env_importance_sampling=True)),
        # the stack and env NEE together on the BVH tier (B1b+c+d)
        "dragon_sky_nee": (dragon_sky, ht.RenderSettings(
            **dbase, use_envmap=True, env_importance_sampling=True,
            env_mip_level=0)),
    }

    def compare_as_read(sc, got, ref):
        """Phase 11's check, with the final direction (7-9) held where the
        sky pass reads it, on rays that reached the sky, and the pdf (10)
        as the sky pass reads it: through the balance-heuristic weight
        `env_mis_weight`, on those rays, at rtol 1e-2. Returns the rays
        outside (the other outputs, the direction, the weight), the
        largest difference, the sky rays, and for the record the rays
        whose raw pdf is outside rtol 1e-2 (on the sky rays and on every
        ray), their pdf range, and the unread rays' largest difference in
        7-10 with its column."""
        sky_rays = (ref[:, 3:6] != 0).any(dim=1)
        keep = [c for c in range(got.shape[1]) if c not in (7, 8, 9, 10)]
        n_bad, err = compare(got[:, keep], ref[:, keep])
        n_dir, err_dir = compare(got[sky_rays, 7:10], ref[sky_rays, 7:10])
        pdf_rec = (0, 0, None)
        bad_w = 0
        if got.shape[1] > 10:
            w, w_ref = (env_mis_weight(sc, x)[sky_rays].cpu().numpy()
                        for x in (got, ref))
            bad_w = int((np.abs(w - w_ref) > PARITY_TOL + PDF_RTOL
                         * np.abs(w_ref)).sum())
            pdf, pdf_ref = got[:, 10].cpu().numpy(), ref[:, 10].cpu().numpy()
            out = (np.abs(pdf - pdf_ref) > PARITY_TOL + PDF_RTOL
                   * np.abs(pdf_ref))
            sky_out = out & sky_rays.cpu().numpy()
            pdf_rec = (int(sky_out.sum()), int(out.sum()),
                       (float(np.abs(pdf_ref[sky_out]).min()),
                        float(np.abs(pdf_ref[sky_out]).max()))
                       if sky_out.any() else None)
        unread = (got[~sky_rays, 7:11] - ref[~sky_rays, 7:11]).abs()
        unread = ((float(unread.max()), 7 + int(unread.max(dim=0).values
                                                .argmax()))
                  if unread.numel() else (0.0, None))
        return (n_bad, n_dir, bad_w, max(err, err_dir), int(sky_rays.sum()),
                pdf_rec, unread)

    parity17 = {}
    for name, (sc, st17) in cases17.items():
        pix = torch.arange(st17.num_pixels, device=dev)
        for frame in (1, 2, 3):
            o17, d17, sidx17, seed17 = rays(pix, 4, 4, st17, frame, dcam)
            got = mk.trace_fused_outputs(sc, o17, d17, dcam.far, sidx17,
                                         seed17, st17)
            ref = mk.trace_color_fused_reference(sc, o17, d17, dcam.far,
                                                 sidx17, seed17, st17)
            col = mk.trace_color_fused(sc, o17, d17, dcam.far, sidx17,
                                       seed17, st17)
            torch.cuda.synchronize()
            n17 = got.shape[0]
            (n_bad, n_dir, bad_w, err, n_sky, pdf_rec,
             unread) = compare_as_read(sc, got, ref)
            n_col, err_col = compare(col, deferred_sky(sc, st17, ref))
            parity17[name] = max(parity17.get(name, 0.0), err, err_col)
            print(f"[17] {name}, frame {frame}: {n17} rays, "
                  f"{st17.max_bounces} bounces; outputs (but 7-10) max "
                  f"|diff| {err:.3e}, {n_bad} rays outside {PARITY_TOL}; "
                  f"on the {n_sky} rays that reached the sky: final "
                  f"direction {n_dir} outside, MIS weight {bad_w} outside "
                  f"rtol {PDF_RTOL} (raw pdf: {pdf_rec[0]} outside, at "
                  f"plain pdfs {pdf_rec[2]}; {pdf_rec[1]} over every ray); "
                  f"unread rays' max |diff| {unread[0]:.3e} in output "
                  f"{unread[1]}; color after the sky max |diff| "
                  f"{err_col:.3e}, {n_col} rays outside", flush=True)
            assert max(n_bad, n_dir, bad_w, n_col) <= (
                PARITY_MAX_OUTSIDE * n17), (name, frame)
            assert np.isfinite(col.cpu().numpy()).all(), name

    # --- 18. the Testing-Scene goldens through B1d
    goldens18 = {
        "testing_active": (
            testing_scene.testing_scene(False).build(envmap=sky, device=dev),
            testing_scene.testing_scene_camera(device=dev),
            ht.RenderSettings(width=64, height=64, samples_per_pixel=8,
                              max_bounces=4, use_envmap=True,
                              ray_chunk_size=4096), (5e-3, 1.0)),
        "testing_composite": (
            testing_scene.testing_scene(True).build(envmap=sky, device=dev),
            ht.make_camera(position=(3.48, 1.8, 12.2),
                           target=(3.48, 1.0, 17.55), fov_deg=60, near=0.6,
                           far=1000, device=dev),
            ht.RenderSettings(width=128, height=128, samples_per_pixel=4,
                              max_bounces=5, use_envmap=True,
                              ray_chunk_size=16384), (2e-2, 16.0)),
    }
    for name, (sc, cm, st18, (mae_tol, worst_tol)) in goldens18.items():
        golden = np.load(ROOT / "tests" / "golden" / f"{name}.npz")["image"]
        assert mk.uses_bvh(sc), name
        before = mk.LAUNCHES
        img = ht.Renderer(sc, cm, st18).step()
        assert mk.LAUNCHES > before, f"{name} did not run the kernel"
        launches18 = mk.LAUNCHES - before
        assert img.shape == golden.shape and np.isfinite(img).all()
        traverse.LAUNCHES = 0
        lock = ht.Renderer(sc, cm, st18.replace(fused=ht.Fused.OFF)).step()
        assert traverse.LAUNCHES > 0 and mk.LAUNCHES == before + launches18
        lock_launches = traverse.LAUNCHES
        # per ray, phase 17's check: the frame's rays through B1d against
        # the world-space lockstep on the same rays (B3's hits, equal to
        # BRUTE's in phase 16; BRUTE over ~78k triangles is too slow here)
        spp = st18.samples_per_pixel
        o18, d18, sidx18, seed18 = rays(
            torch.arange(st18.num_pixels, device=dev), spp, spp, st18, 1, cm)
        n18 = o18.shape[0]
        got = mk.trace_fused_outputs(sc, o18, d18, cm.far, sidx18, seed18,
                                     st18)
        ref = tr.trace_rays(sc, o18, d18, cm.far.expand(n18), sidx18, seed18,
                            st18.replace(intersector=ht.Intersector.PALLAS)
                            ).outputs
        col = mk.trace_color_fused(sc, o18, d18, cm.far, sidx18, seed18,
                                   st18)
        n_bad, n_dir, bad_w, err, n_sky, _, _ = compare_as_read(sc, got, ref)
        n_col, err_col = compare(col, deferred_sky(sc, st18, ref))
        apart = (np.abs(img - lock) > PARITY_TOL + PARITY_TOL
                 * np.abs(lock)).any(axis=-1)
        diff = np.abs(img - golden).max(axis=-1)
        diff_lock = np.abs(lock - golden).max(axis=-1)
        mae = float(np.abs(img - golden).mean())
        over = diff >= worst_tol
        shared = over & (diff_lock >= worst_tol) & ~apart
        print(f"[18] golden {name} ({sc.num_triangles} triangles, "
              f"{sc.num_spheres} spheres): {launches18} launches, MAE "
              f"{mae:.3e} (< {mae_tol}), worst pixel {diff.max():.3e} "
              f"(< {worst_tol}); pixels at or over it: "
              f"{np.argwhere(over).tolist()}, of which the world-space "
              f"lockstep frame ({lock_launches} B3 launches) reproduces "
              f"{np.argwhere(shared).tolist()}; frame vs that lockstep max "
              f"|diff| {float(np.abs(img - lock).max()):.3e}, "
              f"{int(apart.sum())} pixels outside {PARITY_TOL}; per ray "
              f"({n18} rays) vs that lockstep: outputs (but 7-10) max |diff|"
              f" {err:.3e}, {n_bad} outside; on the {n_sky} sky rays final "
              f"direction {n_dir}, MIS weight {bad_w} outside; color after "
              f"the sky max |diff| {err_col:.3e}, {n_col} rays outside",
              flush=True)
        assert max(n_bad, n_dir, bad_w, n_col) <= PARITY_MAX_OUTSIDE * n18, (
            name)
        assert mae < mae_tol, f"golden {name} failed"
        assert not (over & ~shared).any(), f"golden {name} worst pixel"

    # --- 19. times at the launch shape (262144 rays)
    far_cam = dcam.far.expand(o_cam.shape[0]).contiguous()
    pool = _pool_bounce(dragon, st_d, _make_pool(
        o_cam, d_cam, dcam.far, sidx_cam, seed_cam, True), 0)
    o_b, d_b = pool.origin.contiguous(), pool.direction.contiguous()
    seed_b = torch.where(pool.active, far_cam, -1.0)

    def profiled_ms(fn, key, reps=10):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages() if key in r.key]
        return sum(_self_device_us(r) for r in rows) / 1e3 / reps

    b3_rays = {"camera": (o_cam, d_cam, far_cam),
               "bounce": (o_b, d_b, seed_b)}
    times19, work19 = {}, {}
    for name, (o19, d19, s19) in b3_rays.items():
        fn = lambda: traverse.traverse_world(wb, o19, d19, s19)
        out = fn()
        torch.cuda.synchronize()
        work19[name] = (int(out[5].sum()), int(out[6].sum()),
                        int((s19 > 0).sum()))
        k_ms = [_cuda_ms(fn, 10), _cuda_ms(fn, 10)]
        times19[name] = (k_ms, profiled_ms(fn, "traverse_kernel"))
        print(f"[19] B3 on the glass dragon's {name} rays ({o19.shape[0]}, "
              f"{work19[name][2]} walked): {k_ms} ms (events), "
              f"{times19[name][1]:.4f} ms (device); {work19[name][0]} "
              f"triangle and {work19[name][1]} box tests | {card}",
              flush=True)
    small = slice(0, 16384)
    b3_plain = lambda: traverse.traverse_world_reference(
        wb, o_cam[small], d_cam[small], far_cam[small])
    b3_plain_ms = [_cuda_ms(b3_plain, 1), _cuda_ms(b3_plain, 1)]
    print(f"[19] the traversal kernel's plain version (brute force over "
          f"{dragon.num_triangles} "
          f"triangles, not for speed) at 16384 rays: {b3_plain_ms} ms",
          flush=True)

    shapes19 = {  # B1d variant: (scene, settings); the dragon camera's rays
        "B1b+d": (dragon, st_d),
        "B1d": (sky_hero, st_d.replace(max_bounces=4, use_envmap=True,
                                       env_mip_level=0)),
        "B1c+d": (sky_hero, st_d.replace(max_bounces=4, use_envmap=True,
                                         env_importance_sampling=True,
                                         env_mip_level=0)),
        "B1b+c+d": (dragon_sky, st_d.replace(use_envmap=True,
                                             env_importance_sampling=True,
                                             env_mip_level=0)),
    }
    b1d = {}
    for name, (sc, st19) in shapes19.items():
        tab19, et19 = mk._scene_tables(sc), mk.env_table(sc)
        kernel = lambda: mk.trace_fused_outputs(
            sc, o_cam, d_cam, dcam.far, sidx_cam, seed_cam, st19, tab19, et19)
        plain = lambda: mk.trace_color_fused_reference(
            sc, o_cam[small], d_cam[small], dcam.far, sidx_cam[small],
            seed_cam[small], st19)
        got = kernel()
        torch.cuda.synchronize()
        assert np.isfinite(got.cpu().numpy()).all(), name
        k_ms = [_cuda_ms(kernel, 5), _cuda_ms(kernel, 5)]
        dev_ms = profiled_ms(kernel, "megakernel<", reps=5)
        p_ms = [_cuda_ms(plain, 1), _cuda_ms(plain, 1)]
        w = _path_work(sc, o_cam, d_cam, dcam.far, sidx_cam, seed_cam, st19)
        ops = _path_ops(w, sc.any_transmissive, "c" in name)
        nbytes = (o_cam.shape[0] * (32 + 4 * got.shape[1])
                  + _table_bytes((*tab19, sc.wbvh.nodes, et19)))
        b1d[name] = dict(ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, work=w,
                         bound=_bound(nbytes, ops), res=res[name])
        print(f"[19] {name}: one launch of {o_cam.shape[0]} rays, "
              f"{st19.max_bounces} bounces: {k_ms} ms (events), {dev_ms:.4f}"
              f" ms (device); registers, spill bytes {res[name]}; plain "
              f"(lockstep, brute force) at 16384 rays {p_ms} ms; work {w}; "
              f"bound {b1d[name]['bound'][0]:.4f} ms by "
              f"{b1d[name]['bound'][1]} | {card}", flush=True)

    # --- 20. the glass dragon at bench.py's configuration
    mk.LAUNCHES = adj.LAUNCHES = 0
    traverse.LAUNCHES = 0
    ht.render_frame(dragon, dcam, st_d, 0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames20 = [ht.render_frame(dragon, dcam, st_d, f + 1) for f in range(2)]
    torch.cuda.synchronize()
    dt20 = time.perf_counter() - t0
    launches20 = (mk.LAUNCHES, adj.LAUNCHES, traverse.LAUNCHES)
    assert launches20 == (3 * 32, 0, 0), launches20
    for img in frames20:
        assert img.shape == (512, 512, 3)
        assert bool(torch.isfinite(img).all()), "glass dragon not finite"
    mrays20 = st_d.samples_per_pixel * st_d.num_pixels * 2 / dt20 / 1e6
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ht.render_frame(dragon, dcam, st_d, 3)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    busy_ms = sum(_self_device_us(r) for r in prof.key_averages()) / 1e3
    idle20 = 1.0 - busy_ms / (dt20 / 2 * 1e3)
    st20s = st_d.replace(width=256, height=256)
    k_img = ht.render_frame(dragon, dcam, st20s, 1)
    traverse.LAUNCHES = 0
    before = mk.LAUNCHES
    p_img = ht.render_frame(dragon, dcam, st20s.replace(fused=ht.Fused.OFF),
                            1)
    torch.cuda.synchronize()
    b3_launches = traverse.LAUNCHES
    assert b3_launches > 0 and mk.LAUNCHES == before, "Fused.OFF route"
    rel20 = abs(float(k_img.mean()) - float(p_img.mean())) / abs(
        float(p_img.mean()))
    print(f"[20] glass dragon {st_d.width}x{st_d.height} "
          f"{st_d.samples_per_pixel} spp {st_d.max_bounces} bounces: "
          f"{launches20[0]} B1d launches in 3 frames; 2 frames in "
          f"{dt20:.4f} s = {mrays20:.3f} Mrays/s; device busy {busy_ms:.1f} "
          f"ms of a frame (profiled frame {prof_s * 1e3:.1f} ms), idle share"
          f" {idle20:.3f} of the timed frames' mean; 256x256 Fused.OFF "
          f"frame ({b3_launches} launches of the traversal kernel) mean "
          f"radiance vs the kernel route rel {rel20:.2e} (< 2e-2) | {card}",
          flush=True)
    assert rel20 < 2e-2, "glass dragon mean radiance disagrees with plain"

    # --- 21. the record of every kernel: bounds from the work each
    # launch shape needs on these inputs
    w_a = _path_work(scene, o, d, cam.far, sidx, seed, st_a)
    w_b = _path_work(glass, o_g, d_g, cam.far, sidx_g, seed_g, st_g)
    w_c = _path_work(spheres, o_e, d_e, sky_cam.far, sidx_e, seed_e, st_e)
    n = o.shape[0]
    tab_a, tab_b, tab_c = (mk._scene_tables(x) for x in (scene, glass,
                                                         spheres))
    k_mat = 12 * 4 * scene.materials.count
    bounds = {
        "B1a": _bound(n * 72 + _table_bytes(tab_a),
                      _path_ops(w_a, False, False)),
        "B1b": _bound(n * 72 + _table_bytes(tab_b),
                      _path_ops(w_b, True, False)),
        "B1c": _bound(n * 80 + _table_bytes((*tab_c, env_tab)),
                      _path_ops(w_c, False, True)),
        "B1d": b1d["B1b+d"]["bound"],
        "B2": _bound(n * 44 + _table_bytes(tab_a) + k_mat,
                     _path_ops(w_a, False, False, adjoint=True)),
        "B2b": _bound(n * 44 + _table_bytes(tab_b) + 12 * 4
                      * glass.materials.count, _path_ops(w_b, True, False,
                                                         adjoint=True)),
    }
    b3_bytes = (n * 56 + _table_bytes((wb.nodes, wb.tris, wb.tri_map)))
    tt, bt, _ = work19["camera"]
    bounds["B3"] = _bound(b3_bytes, tt * OPS_TRI + bt * OPS_BOX)
    print(f"[21] path work at the launch shapes: B1a {w_a}, B1b {w_b}, B1c "
          f"{w_c}; bounds (ms, by) {bounds}", flush=True)

    def entry(name, replaces, source, launches, err, k_ms, p_ms, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": float(np.mean(k_ms)),
                "plain_ms": float(np.mean(p_ms)),
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": None, **extra}

    mega = "halogen_tpu_torch/csrc/megakernel.cu"
    adjs = "halogen_tpu_torch/csrc/adjoint.cu"
    trav = "halogen_tpu_torch/csrc/traverse.cu"
    reg = lambda name: dict(registers=res[name][0],
                            spill_store_bytes=res[name][1])
    dmain = b1d["B1b+d"]
    kernels = [
        entry("B1a", "halogen_tpu/kernels/megakernel.py:945", mega, launches,
              max_err, kernel_ms, plain_ms, **reg("B1a"),
              rays_outside_tol=int(n_bad), rays=n, parity_max_abs_err=parity,
              frame_ms=dt / 4 * 1000.0,
              plain_frame_ms=plain_frame_s * 1000.0, mrays_per_s=mrays,
              build_s=build_s, ms_again=float(np.mean(times13["B1a"][0]))),
        entry("B1b", "halogen_tpu/kernels/megakernel.py:225", mega,
              main14["glass"][0], err13["B1b"], *times13["B1b"],
              **reg("B1b"), parity_max_abs_err={
                  k: v for k, v in parity11.items() if "glass" in k},
              frame_ms=main14["glass"][2] * 1000.0,
              mrays_per_s=main14["glass"][1]),
        entry("B1c", "halogen_tpu/kernels/megakernel.py:1380", mega,
              main14["envmap_1024"][0], err13["B1c"], *times13["B1c"],
              **reg("B1c"), parity_max_abs_err={
                  k: v for k, v in parity11.items() if "sky" in k},
              frame_ms=main14["envmap_1024"][2] * 1000.0,
              mrays_per_s=main14["envmap_1024"][1]),
        entry("B1d", "halogen_tpu/kernels/megakernel.py:523", mega,
              launches20[0], max(parity17.values()), dmain["ms"],
              dmain["plain_ms"], **reg("B1b+d"), plain_rays=16384,
              device_ms=dmain["device_ms"], parity_max_abs_err=parity17,
              variants={k: dict(ms=v["ms"], device_ms=v["device_ms"],
                                plain_ms=v["plain_ms"],
                                bound_ms=v["bound"][0],
                                registers=v["res"][0],
                                spill_store_bytes=v["res"][1])
                        for k, v in b1d.items()},
              frame_ms=dt20 / 2 * 1000.0, mrays_per_s=mrays20,
              device_idle_share=idle20),
        entry("B2", "halogen_tpu/kernels/adjoint.py:80", adjs,
              fb_launches[1], adj_err, adj_ms, adj_plain_ms, **reg("B2"),
              parity_max_abs_err=adj_parity, fwd_bwd_mrays_per_s=fb_mrays,
              fwd_bwd_step_ms=dt9 / 2 * 1000.0,
              fit_s_per_step_median=fit_s,
              fit_loss_first_last=[losses[0], losses[-1]],
              fit_albedo_err_before_after=[err0, err1],
              fit_held_out_loss=held),
        entry("B2b", "halogen_tpu/kernels/adjoint.py:244", adjs, fb15[1],
              b2b_err, b2b_k, b2b_p, **reg("B2b"),
              parity_max_abs_err=adj15, fwd_bwd_mrays_per_s=fb15_mrays,
              fwd_bwd_step_ms=dt15 / 2 * 1000.0),
        entry("B3", "halogen_tpu/kernels/bvh_pallas.py:142", trav,
              b3_launches, b3_err, times19["camera"][0], b3_plain_ms,
              **reg("B3"), plain_rays=16384,
              device_ms=times19["camera"][1],
              bounce_rays_ms=times19["bounce"][0],
              bounce_rays_device_ms=times19["bounce"][1]),
    ]
    for name, route, replaces in (
            ("B4", "TREELET", "halogen_tpu/kernels/treelet_bvh.py:192"),
            ("B5", "FLATLET", "halogen_tpu/kernels/flatlet.py:199"),
            ("B6", "RAYLET", "halogen_tpu/kernels/raylet.py:208")):
        bounds[name] = bounds["B3"]
        kernels.append(entry(
            name, replaces, trav, routes16[route][0], routes16[route][1],
            times19["camera"][0], b3_plain_ms, plain_rays=16384,
            served_by="B3", intersector=route))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
