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
     JAX package as well (PERF.md).
The last lines are a JSON record of both kernels, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
CAM = dict(position=(0.0, 0.0, 3.2), target=(0.0, 0.0, 0.0), fov_deg=40.0)
PARITY_TOL = 1e-4
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

    def rays(pix, lanes, spp, st, frame):
        pixb = pix.repeat_interleave(lanes)
        lane = torch.arange(lanes, device=dev).repeat(pix.shape[0])
        sidx = sob.sample_index(frame, lane, spp)
        seed = sob.pixel_seed(pixb)
        o, d = generate_rays(cam, pixb % st.width, pixb // st.width,
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

    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "halogen_tpu_torch/csrc/megakernel.cu",
        "replaces": "halogen_tpu/kernels/megakernel.py:945",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "rays_outside_tol": int(n_bad),
        "rays": n,
        "parity_max_abs_err": parity,
        "frame_ms": dt / 4 * 1000.0,
        "plain_frame_ms": plain_frame_s * 1000.0,
        "mrays_per_s": mrays,
        "build_s": build_s,
    }, {
        "name": "adjoint",
        "route": "cuda",
        "source": "halogen_tpu_torch/csrc/adjoint.cu",
        "replaces": "halogen_tpu/kernels/adjoint.py:80",
        "launches": fb_launches[1],
        "max_abs_err": adj_err,
        "ms": a_ms,
        "plain_ms": ap_ms,
        "rays": n,
        "parity_max_abs_err": adj_parity,
        "fwd_bwd_mrays_per_s": fb_mrays,
        "fwd_bwd_step_ms": dt9 / 2 * 1000.0,
        "fwd_bwd_megakernel_launches": fb_launches[0],
        "fit_s_per_step_median": fit_s,
        "fit_loss_first_last": [losses[0], losses[-1]],
        "fit_albedo_err_before_after": [err0, err1],
        "fit_held_out_loss": held,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
