#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit
(no phase is caught):
  1. require a CUDA device; print the card's name and power limit;
  2. build both kernels (the megakernel and its adjoint) from
     `halogen_tpu_torch/csrc/`, one nvcc process per source, in parallel;
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
     spp; a backward on an envmap scene raises NotImplementedError.
The last lines are a JSON record of the five kernel variants, the card's
name and power limit, and {"ok": true, "device": {...}}.
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
    names = {"megakernelILb0ELb0E": "B1a", "megakernelILb1ELb0E": "B1b",
             "megakernelILb0ELb1E": "B1c", "megakernelILb1ELb1E": "B1b+c",
             "adjoint_kernelILb0E": "B2", "adjoint_kernelILb1E": "B2b"}
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
    assert set(res) == {"B1a", "B1b", "B1c", "B1b+c", "B2", "B2b"}, res
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

    # --- 16. the record of every kernel variant
    def entry(name, replaces, launches, err, times, extra):
        k_ms, p_ms = times
        return {"name": name, "route": "cuda", "source": extra.pop("source"),
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": float(np.mean(k_ms)),
                "plain_ms": float(np.mean(p_ms)), "registers": res[name][0],
                "spill_store_bytes": res[name][1], **extra}

    mega = "halogen_tpu_torch/csrc/megakernel.cu"
    adjs = "halogen_tpu_torch/csrc/adjoint.cu"
    print(json.dumps({"kernels": [
        entry("B1a", "halogen_tpu/kernels/megakernel.py:945", launches,
              max_err, (kernel_ms, plain_ms), dict(
                  source=mega, rays_outside_tol=int(n_bad), rays=n,
                  parity_max_abs_err=parity, frame_ms=dt / 4 * 1000.0,
                  plain_frame_ms=plain_frame_s * 1000.0, mrays_per_s=mrays,
                  build_s=build_s, ms_again=float(np.mean(
                      times13["B1a"][0])))),
        entry("B1b", "halogen_tpu/kernels/megakernel.py:225", main14[
            "glass"][0], err13["B1b"], times13["B1b"], dict(
                source=mega, parity_max_abs_err={
                    k: v for k, v in parity11.items() if "glass" in k},
                frame_ms=main14["glass"][2] * 1000.0,
                mrays_per_s=main14["glass"][1])),
        entry("B1c", "halogen_tpu/kernels/megakernel.py:1380",
              main14["envmap_1024"][0], err13["B1c"], times13["B1c"], dict(
                  source=mega, parity_max_abs_err={
                      k: v for k, v in parity11.items() if "sky" in k},
                  frame_ms=main14["envmap_1024"][2] * 1000.0,
                  mrays_per_s=main14["envmap_1024"][1])),
        entry("B2", "halogen_tpu/kernels/adjoint.py:80", fb_launches[1],
              adj_err, (adj_ms, adj_plain_ms), dict(
                  source=adjs, parity_max_abs_err=adj_parity,
                  fwd_bwd_mrays_per_s=fb_mrays,
                  fwd_bwd_step_ms=dt9 / 2 * 1000.0,
                  fit_s_per_step_median=fit_s,
                  fit_loss_first_last=[losses[0], losses[-1]],
                  fit_albedo_err_before_after=[err0, err1],
                  fit_held_out_loss=held)),
        entry("B2b", "halogen_tpu/kernels/adjoint.py:244", fb15[1], b2b_err,
              (b2b_k, b2b_p), dict(
                  source=adjs, parity_max_abs_err=adj15,
                  fwd_bwd_mrays_per_s=fb15_mrays,
                  fwd_bwd_step_ms=dt15 / 2 * 1000.0)),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
