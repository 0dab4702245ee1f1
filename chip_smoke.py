#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit
(no phase is caught):
  1. require a CUDA device; print the card's name and power limit;
  2. build the four kernel libraries (the megakernel, its adjoint, the
     world-BVH traversal and the sky pair) from `halogen_tpu_torch/csrc/`,
     one nvcc process per source, in parallel, and print each kernel's
     registers, spills and static shared memory;
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
     frames through `render_frame` (each group one launch that makes its
     own rays), with the kernel's launch count; one
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
     `render_loss_grad` on the record route (64 recording forwards and 64
     sweeps a step, no replay), then the same 2 steps with
     `adjoint.RECORD_BUDGET = 0` (64 forwards and 64 replays a step), whose
     losses and gradients must equal the record route's bit for bit, each
     with its peak device memory; then, at 64x64 and 16 spp, its grads
     against the plain route (`Fused.OFF`) at phase 7's tolerance;
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
 13. the registers and spill bytes of every variant (the adjoints' with
     the transcript in shared and in device memory; those built before
     B1e must equal `RESOURCES_BEFORE_B1E`, but the two replay variants
     of `RESOURCES_SINCE_SHARED_SWEEP` and the five of
     `RESOURCES_SINCE_DIVISION`; the record route's forward
     variants on both tiers and its sweeps printed, and no sweep may
     spill; B1e+d's light variants, whose shadow ray is an any-hit walk,
     B1e's brute-tier variants, whose shadow scan culls, and the light-NEE
     probes of both tiers printed), and the forward
     variants' and their plain versions' times at the launch shape
     (262144 rays): B1a at 6 bounces, the glass variant at 8, the env-NEE
     variant at 4;
 14. the forward paths at full size: the glass box (512x512, 32 spp, 8
     bounces, one warm-up and 4 timed frames) and the `envmap_1024` preset
     (material spheres under the sky, 1024x1024, 16 spp, 4 bounces, env
     NEE, mip level 0; one warm-up and 2 timed frames; its sky pass the
     sky kernel, one launch a group), each with its launch count and
     Mrays/s; then one 256x256 frame of each against the plain route,
     mean radiance within 2%;
 15. the glass adjoint: vs its plain version in phase 11's four glass
     cases (phase 7's tolerance), bitwise repeatable, its replay equal to
     the glass forward bit for bit; its time at the launch shape; the
     glass fwd+bwd step (`render_loss_grad`, 256x256, 256 spp, 8 bounces:
     as phase 9's, on the record route and again with RECORD_BUDGET = 0,
     equal bits) and its grads vs `Fused.OFF` at 64x64, 16
     spp; the envmap backward through `render_loss_grad` (Cornell glossy
     under the sky, and the spheres under it with env NEE; materials and
     mips, 64x64, 16 spp): every kernel of its path launched (the
     recording forward and the sweep, the sky pair), vs
     `Fused.OFF` with the same per-pixel cotangent, zero on the pixels
     whose forwards round apart (at most 0.1%): the materials at phase 7's
     tolerance, every mip at 1e-4 of its largest + 1e-6;
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
 21. the adjoint's transcript routes: the glass adjoint at 20 bounces
     without RR, past the shared-memory budget, so in device memory: vs
     its plain version at phase 7's tolerance, bitwise repeatable, its
     replay equal to the forward bit for bit; and B2 and B2b at 6 and 8
     bounces through both routes, which must give the same bits;
 22. B3 and B1d on a walk 19 stack entries deep: the deep strip
     (`meshes.deep_strip_scene`, max_leaf 1) under the sky, 16384 camera
     rays: B3 vs its plain version (t, u, v at 1e-5, the same triangles,
     rays that find triangle 1 in the 19th entry), and B1c+d vs plain as
     in phase 17;
 23. B1a then B2, and B1b then B2b, on the same rays at the launch shape,
     in turns (forward, adjoint, adjoint, forward; events and device
     time): the adjoint's own share;
 25. the rays the kernel makes itself (a launch from pixels, as
     `render_pixels` issues it) against `group_rays` on the card, at frame
     3, first lane 2, two lanes a pixel of a 64x64 frame: sample index and
     seed bit for bit, origin and direction within 1e-6 (the float ops are
     `generate_rays`'; `logf`, `sinf`, `cosf` and the 3x3 transform, a
     GEMM in torch, may round an ulp apart), the count of rays not bit
     for bit printed; and the launch from pixels against the explicit-ray
     launch on the rays it wrote, outputs bit for bit: B1a, B1b through a
     thin lens, B1c, B1b with the PRNG sampler, B1b+c+d;
 26. warps that refill against one ray a thread, outputs bit for bit, at
     100,003 rays (ragged) and 1,000 (fewer than the grid's threads): B1a,
     B1b, B1c;
 27. the launch from pixels at the launch shape (262144 rays, more than
     the persistent grid holds, so most rays are made by lanes that fell
     free), for B1a, B1b, B1c and, on the glass dragon camera's pixels,
     B1b+d (one ray a thread) and B1c+d (refilling): its rays against
     `group_rays` as in phase 25, its outputs bit for bit against the
     explicit-ray launch on the rays it wrote, and against the plain
     version (`group_rays`, then the lockstep) at phase 11's tolerance
     (the BVH tier as in phase 17, on every 16th ray); this error and the
     launch's time are the kernels record's. Then B1a-c from pixels, from
     explicit rays, and from explicit rays with one ray a thread (events
     and profiler device time), registers and spills;
 28. the adjoint's BVH tier: B2b+d on the glass dragon and B2+d on a
     1,280-triangle metal dragon in the Cornell shell, at the glass
     dragon's launch shape (262144 camera rays, 12 bounces): vs plain
     (brute-force hits) on every 16th ray at phase 7's tolerance, bitwise
     repeatable, the replay equal to B1d's forward bit for bit, both
     transcript routes the same bits; times at the launch shape. Then the
     record route at the same shape for B2+d, B2b+d, B2c+d, B2c+n+d (the
     1,280-triangle dragon under the sky, without and with env NEE) and
     B2b+c+n+d (the glass dragon under the sky with env NEE): the
     forward's outputs with the record equal those without bit for bit;
     the sweep's [K, 12|13] and env-NEE records equal the replay's bit for
     bit, and repeat; the sweep within 1e-5 * max |column| + 1e-7 of
     `sweep_reference` on the same record; the record against
     `record_transcript_reference` on every 16th ray whose forward
     outputs kernel and plain agree on at phase 11's tolerance (up to 1%
     may not: a drifted final direction, phase 17): ids and masks equal,
     floats at phase 11's tolerance, in glass on all but 0.1% of those
     rays, there also on a second frame's rays, with where and how the
     floats part (the drift of phase 17 reaching a hit distance); the
     record route against the plain backward at phase 7's
     tolerance on those rays; times (events and profiler device time) of
     the forward without and with the record, the sweep, the replay and
     the sweep's plain version, the sweep's bound from the shaded bounces
     its record holds;
 29. the sky pair vs `deferred_sky` (the `envmap_1024` launch shape's
     outputs, and Cornell glossy under the sky with the mip bias): the
     forward at 1e-4 per ray (at most 0.1% outside), the backward's
     cotangents of the miss attenuation and roughness at 1e-4 of their
     column's largest, each mip's at 1e-4 of its largest + 1e-6, two
     calls bitwise equal; then the backward's ordering and sums at three
     sets of keys (the launch shape's taps, the same rays' taps into a
     512x1024 map of 698,880 texels, and the launch shape's env-NEE
     records from B2c+n): the ordering equal to `torch.sort(stable=
     True)`'s permutation on the keys >= 0, every mip within 1e-4 of its
     largest + 1e-6 of `index_add_` in float64, two calls bitwise equal,
     and equal to `reduce_texels_model` bit for bit; each stage timed
     (CUDA events, profiler device time per call) beside its library
     call (`torch.sort`, `index_add_`) and its bound; the taps kernel,
     the whole backward and both forward kernels and their plain
     versions timed at the launch shape;
 30. the adjoint's sky variants vs plain, 64x64 x 4 lanes: the sky alone
     (B2c), env NEE (B2c+n), glass under the sky with env NEE (B2b+c+n),
     and the same on the BVH tier (B2c+d, B2c+n+d, B2b+c+n+d): [K, 13] at
     phase 7's tolerance, every mip at 1e-4 of its largest + 1e-6, on the
     rays whose forward outputs (color, miss attenuation, roughness) the
     kernel and plain agree on at phase 11's tolerance (at most 0.1% may
     not: a near-mirror lobe's pdf, phase 17); two calls bitwise equal,
     the replay equal to the forward; `adjoint.trace_grad_fused` takes
     them through the main path's autograd Functions, which on the BVH
     tier record and sweep (the record route), equal to the replay
     (`RECORD_BUDGET = 0`) bit for bit, every mip too; B2c and B2c+n timed
     at the `envmap_1024` launch shape, where [K, 13] and B2c+n's record
     sums into the finest mip are held to plain too;
 31. the full-width gradient steps, each a warm-up and 2 timed
     `render_loss_grad` steps with every kernel count set to 0 before them
     (each kernel of the path must launch, and the other route's none):
     the glass dragon at `bench.py`'s configuration (512x512, 32 spp, 12
     bounces), the `envmap_1024` preset with {"materials", "env_mips"}, a
     1,280-triangle metal dragon and Cornell glossy under the sky at
     256x256, all on the record route (both tiers record), then each again
     with `adjoint.RECORD_BUDGET = 0` (the replay), whose losses, material
     gradients and mips must equal the record route's bit for bit; each
     with its launches, step time, Mrays/s (fwd+bwd), device idle share
     and peak device memory (`torch.cuda.max_memory_allocated`);
     the `envmap_1024` forward frame (phase 14) beside the torch sky
     pass's figures; and a 10-step `fit_materials(optimize_env=True)` of
     the `envmap_1024` scene at 256x256 from a sky at half brightness and
     a perturbed albedo: the held-out loss must fall, every texel >= 0;
 32. the area-light NEE variants (B1e) vs their plain version, the
     lockstep on the card (`Fused.OFF`'s closest hits: brute force up to
     4096 triangles, B3 above), 64x64 pixels x 4 lanes: the Cornell box
     (a triangle panel), `glow_orbs` (four sphere emitters), the blocked
     plate of `tests/test_light_nee.py:74-92`, the glass box (B1b+e),
     Cornell glossy under the sky with env NEE and light NEE (B1c+e), the
     glass dragon (B1b+e+d) and `testing_scene(False)` (77,364 triangles
     and a long CDF, B1e+d): per ray at phase 11's tolerance, with env NEE
     or on the BVH tier the final direction and the continuation pdf held
     where and as the sky pass reads them (phase 17); each scene's 256x256
     frame through the kernel with its mean radiance within 2% of
     `Fused.OFF`'s; then on the Cornell box at 256x256, 3 bounces, the
     checks of `tests/test_light_nee.py:44-71`: the 96 spp NEE mean within
     6% of the BRDF-only mean, and at 4 spp the NEE frame's mean error
     (against 192 spp of NEE) under 0.75 times the BRDF-only frame's; the
     light-NEE variants' registers and spills; B1e on phase 5's rays
     (Cornell glossy, 6 bounces) and B1b+e+d on phase 19's (the glass
     dragon, 12 bounces) timed beside B1a and B1b+d, with the work their
     rays need and their bound; B1e+d's light shadow rays through the
     light-NEE probe (`megakernel.light_probe`, both walks counted) on the
     glass dragon and the testing scene and at the glass dragon's launch
     shape: the probe deciding by the kernel's any-hit walk equals it bit
     for bit, and deciding by the closest-hit walk (the rule it replaced) its
     outputs part from the kernel's only on rays whose two decisions
     differed, which are counted with the exact ties among them; the
     blocked share and the tests a shadow walk makes under each walk;
     the launch shape's walks timed alone (the probe with one walk or
     none) in turns with B1b+e+d; B1e's light shadow rays through the
     brute tier's probe (the full scan and the culled one, both counted)
     on the Cornell box, `glow_orbs`, the blocked plate and the glass box
     (B1b+e) and at the launch shape of Cornell glossy and of `glow_orbs`
     (phase 5's rays, 6 bounces): deciding by either rule it equals the
     kernel bit for bit, its two decisions never apart; the blocked share,
     the Möller-Trumbore tests and culls a shadow ray, and B1e's bound
     counted from the culled scan's work (beside the full scan's, the
     bound of earlier PRs); each launch shape's
     split (every draw visible, the full scan alone, the culled scan
     alone) timed in turns with B1a and B1e; and `render_loss_grad` with
     light NEE on the card: one recording B1e and one light sweep (B2+l)
     a group, no replay (phase 36 holds it to plain);
 33. light NEE at full width: Cornell glossy (512x512, 32 spp, 6
     bounces, `bench.py`'s), `glow_orbs` at 512x512 and the glass dragon
     (512x512, 32 spp, 12 bounces): a warm-up and 2 timed frames each, the
     launches, Mrays/s, and a profiled frame; for the glass dragon the
     light shadow rays of its first group (phase 32's launch shape);
 34. the CLI on the card, in this process (`halogen_tpu_torch.cli.main`):
     `render --preset cornell_glossy_512 --light-nee --frames 2` (the
     preset's frames win, as in the JAX CLI), `bench --preset glass_dragon
     --light-nee` (its JSON line), `debug-sobol`, `fit --steps 3 --width
     64` and the same with `--light-nee` (on the kernels, finite losses),
     a render resumed from its checkpoint, and `render --sharded` at
     64x64 over a group of this process alone (`nccl`); its files in a
     temporary directory, removed after;
 35. the brute tier's record route, phase 28's checks at the launch
     shapes of phases 5, 13 and 29: B2 (Cornell glossy, 6 bounces), B2b
     (the glass box, 8 bounces, with a second frame's rays), B2c and B2c+n
     (the `envmap_1024` rays, without and with env NEE), B2b+c+n (the glass
     box under the sky with env NEE): outputs with the record equal those
     without, the sweep equal to the replay and repeatable, against
     `sweep_reference`, the record against `record_transcript_reference`,
     the route against the plain backward; times of the forward with and
     without the record, the sweep and the replay, and the sweep's bound;
 36. the light-NEE adjoint (B2+l: B1e's recording variants and the light
     sweep; no replay), 64x64 pixels x 4 lanes on the Cornell box,
     `glow_orbs`, the blocked plate, the glass box (B1b+e), Cornell glossy
     under the sky with env NEE and light NEE (B1c+e), the 1,280-triangle
     metal dragon (B1e+d) and the glass dragon (B1b+e+d): the forward's
     outputs with the record equal those without bit for bit; the sweep
     bitwise repeatable and within phase 7's tolerance of
     `sweep_reference` on the same record; the record against
     `record_transcript_reference` where the forwards agree (ids and masks
     equal, floats at phase 11's tolerance, on at most 0.1% of the rays
     apart in glass, glossy or env-NEE scenes); `render_loss_grad`
     against `Fused.OFF`'s autograd through the lockstep at phase 7's
     tolerance (each route's target its own image + c, c zero on the
     pixels whose forwards round apart), one recording forward and one
     sweep a group, no replay; `glow_orbs`' emitters a d emission; then
     the recording B1e (phase 5's rays) and B1b+e+d (the glass dragon's)
     timed in turns with them without the record, beside their plain
     version, and the light sweep over the Cornell record beside
     `sweep_reference`, with their bounds; the full-width steps
     `cornell_glossy_256_fwd_bwd_light` (`bench.py:128-158`'s step with
     light NEE), `glow_orbs_256_fwd_bwd_light` and
     `glass_dragon_512_fwd_bwd_light` (512x512, 32 spp, 12 bounces), a
     warm-up and 2 timed steps each, every count set to 0 before (the
     recording forward and the sweep must launch, the replay never):
     launches, Mrays/s (fwd+bwd), busy and idle share, peak memory; and a
     10-step `fit_materials` of `glow_orbs` with light NEE at 256x256 from
     a perturbed albedo and emission, whose held-out loss must fall;
 37. the debug views on the card (the lockstep, never the megakernel;
     B3 above `brute_force_max_tris`): the five views of Cornell glossy
     (BRUTE, 4 bounces) and of the glass dragon (4 bounces; through AUTO
     and through `Intersector.PALLAS`, both B3 on the card) at 64x64, 1
     spp, against the port's CPU render of the same settings through the
     same route (`PALLAS` on the CPU for the dragon: its counts from
     `traverse.traverse_world_walk_reference`): on every pixel whose first
     hit and path outputs agree (at most 1% may not), albedo and normal
     within 1e-5 and the count views and per-ray counts equal; B3's seven
     outputs on the glass dragon's 262,144 camera rays equal to the plain
     walk's on the card on every ray; `testing_scene(False)` (77,364
     triangles) in RAY_BOX_TESTS at 512x512, 1 spp: its ms and B3
     launches;
 38. an HDRI file: `procedural_hdri(2048)` written as an EXR and read by
     `load_envmap` (bit for bit), lighting `meshes.outdoors_scene()` (2
     triangles, 5 spheres, one of glass: B1b+c) with env NEE at mip level
     0: a 256x256 16 spp frame's mean within 2% of `Fused.OFF`'s; the
     `envmap_1024` preset's settings (1024x1024, 16 spp, 4 bounces): a
     warm-up and 2 timed frames, launches, Mrays/s, a profiled frame
     (busy ms, idle share); `render_loss_grad` with the mips at 256x256,
     16 spp against `Fused.OFF` at phase 15's tolerances (up to 1% of the
     pixels, whose forwards round apart under the 2000-radiance sun, held
     out), the record route and the sky backward launched, and two more
     steps timed;
 39. sharding: two ranks on the one card (`chip_smoke.py --rank-worker`
     processes, `gloo`) render `dragons_hero` (512x512, 64 spp, 8 bounces)
     under its sky (`--envmap`, B1b+c+d: the preset's own image is black,
     as the JAX CLI's, for no material emits and it leaves use_envmap off)
     over meshes (2, 1) and (1, 2): the ranks' images equal, and
     within atol 2e-5, rtol 1e-4 of one process's `render_frame`; a
     sharded gradient step at 16 spp on each mesh, twice: bit for bit on
     both ranks and on the rerun, against one process's
     `render_loss_grad` at atol 1e-4, rtol 1e-3 (loss rtol 1e-5), each
     rank's backward recording forwards and sweeps, no replay, its peak
     memory printed; then `python -m halogen_tpu_torch.cli render --preset
     dragons_hero --sharded` in this process, one rank over `nccl`, as the
     preset has it (B1b+d, black) and with `--envmap`: its 64 frames each
     equal to `render_frame`'s bit for bit, Mrays/s and seconds; and
     `parallel.scaling_bench` (strong and weak) on the one card, each
     record naming the card and its power limit;
 40. the wavefront scheduler (`RenderSettings.wavefront`) on the card:
     the glass dragon under `Fused.OFF` (256x256, 4 spp, 12 bounces) and
     `testing_scene(False)` in RAY_TRIANGLE_TESTS (512x512, 1 spp), each
     frame with the flag off and on in turns: the images equal bit for
     bit, and on one group every `TraceOut` field (the debug view's
     per-ray test counts among them), B3's launches a frame and rays a launch over the bounces (the
     wavefront's falling, never more launches), its host syncs (one a
     bounce), ms a frame and one group's device busy time (the profiler's
     CUDA activity alone, on a quarter of the frame); then a
     `Fused.OFF` `render_loss_grad` step on the 64x64 metal dragon both
     ways: the loss bit for bit, the gradients at rtol 1e-6, atol 1e-7;
 41. the port's scripts (`python -m halogen_tpu_torch.scripts.<name>`)
     on the card at their default sizes, into a temporary directory, each
     record naming the card: `hero_run` in full (512², 4096 spp over a
     process group of one rank, then a sharded gradient step; its mean
     radiance within 2% of the JAX package's recorded 0.2344),
     `inverse_demo` (64², 80 steps: the held-out loss must fall),
     `turntable` on the glass dragon (its strip and GIF, or without PIL
     the strip as `.npz`),
     `variance_bench` (the MSE lower with each NEE than without), and
     `gen_goldens` (every frame within `tests/test_golden.py`'s MAE bound
     of the JAX golden, and past its worst-pixel bound only where the
     world-space lockstep on the card reproduces the pixel: phase 18's
     rule); each one's kernel launches printed;
 42. light-NEE gradient steps past the record budget, on the route that
     records each group again in its backward ('rerecord',
     `adjoint.record_plan`: the forward launches the plain B1e variant,
     the backward a recording one and the sweep a group): the route
     against the record route on the same step (256x256, 16 spp, two
     launches under a budget of one launch's record) on B1e (Cornell
     glossy), B1c+e (Cornell glossy under the sky with both NEEs, with
     `env_mips`), B1b+e+d (the glass dragon) and B1e+d (the metal
     dragon): loss, gradients and mips bit for bit; then, with the
     default budget, `cornell_glossy_1024_256spp_fwd_bwd_light` (1,024
     launches, 68.7 GB of records on the record route) and
     `glass_dragon_1024_64spp_fwd_bwd_light` (256 launches, 31.7 GB):
     seconds a step over 3 warm steps, a profiled step (busy ms, idle
     share), peak memory, the launches, finite gradients, and two calls
     of one frame bit for bit; a sharded light-NEE step over one
     `nccl` rank past the budget, bit for bit with the same sharded step
     on the record route and within phase 39's tolerance of
     `render_loss_grad`; and a 3-step `fit_materials` past the budget;
 43. the chunk node's two small kernels (`megakernel._FusedChunk`, which
     serves every group of a chunk): `lane_sum` (csrc/megakernel.cu,
     through `halogen_lane_sum`) against `acc + col.reshape(n, spp_block,
     3).sum(dim=1)` bit for bit at 262144 rays, rows of 10, 12 and 3
     floats (the brute tier, env NEE, the sky pass's colour) and 1, 4 and
     8 lanes a pixel, each timed against the plain sum; a Cornell fit
     step's chunk record (Cornell glossy, 256x256, 256 spp, 6 bounces: 64
     groups of 262144 rays) swept by `adjoint.sweep_chunk` against each
     group's `_sweep` over its slice, summed last first, bit for bit, both
     timed, `sum_groups`' device time profiled; then the launches a
     Cornell fit step and a 512x512, 32-spp Cornell frame make: one chunk
     node each, a `lane_sum` a group (64, 32), one `sum_groups` in the
     fit;
 44. the chunk node under the sky (`phase44`, runnable alone as phase
     42): first the sums' add mode (`sky.scatter_texels(..., out=)`) at
     the 4096-px sky's 11,182,080-texel atlas, bit for bit a non-zero
     buffer + the fresh sums, the texels without a tap untouched; then a
     gradient step of the materials and all 6 mips at `testing_fit`'s
     size (the Testing Scene's active set, 480x270, 64 spp: 32 groups of
     259,200 rays, the 4096-px procedural HDRI at mip 1), one chunk node
     and a node a group (`chunk_serves` patched to False) in turns after
     a warm step each: the image, every material field's and every mip's
     gradient bit for bit, the atlases built (1 against 32) and alive
     after the backward (0), `torch.cuda.max_memory_allocated`, ms a
     step, the chunk nodes and launches;
 24. (run last) the work each launch shape of B1a-c, B2 and B2b needs, for
     their bounds, with the mean bounces of a ray and of each 32 rays'
     longest path.
Phases 6, 9, 14, 15, 20, 31, 33 and 36 also profile one frame or step: the
`cudaLaunchKernel` calls, the device's busy time and its idle share; a
Cornell and a glass-box frame must stay under 3,350 launches (a tenth of
what they took when torch made the rays). A kernel's device time is the
profiler's mean over the launches it kept; where it kept none in five
sessions (it can drop events late in a long process) the time reads "not
recorded" (null in the record) beside the CUDA-event time.
The last lines are a JSON record of every kernel (B1a-e, B1e+d, B2, B2b,
B2b+d, B2+d, B2c, B2c+n, the sky forward and backward, B3, the routes
B4-B6 that B3's kernel serves, and B2+l's kernels: "B1e recording",
"B1e+d recording" and "B2+l", the light sweep) with its launches on its
main path, error, times, plain time, bound and library call (B2, B2b,
B2c, B2c+n, B2b+d and B2+d are the record route's sweep, which their
steps launch, with the replay and the recording forward beside them),
the card's name and power limit, and {"ok": true, "device": {...}}.
B3's record carries phase 37's and phase 40's results, the sky
backward's phase 38's and B1d's phases 39's and 41's.
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
# sqrtf as ~20 each)
OPS_TRI, OPS_SPHERE, OPS_BOX = 55, 55, 27
# B1e's cull of a triangle (path_common.cuh shadow_tris): two dot products
# with the normal, the margin's 1-norms (abs an operand modifier) and
# products, four compares; its tvec is Möller-Trumbore's, counted there
OPS_CULL = 27
OPS_SHADE = 230  # an opaque hit: normals, draws, Fresnel, lobes, RR
OPS_GLASS = 50  # + the refraction branch and Beer-Lambert
OPS_NEE = 150  # + two glossy pdfs and the MIS weight (the draw is a row)
# + light NEE: the point on a triangle or the cone direction (two sqrtf,
# three divisions, a cosf and sinf), the two pdfs, one glossy pdf, the MIS
# weight, and the emission's weight at the hit
OPS_LNEE = 200
OPS_ADJ = 100  # + the adjoint's reverse sweep of the bounce
OPS_SWEEP = 60  # the record route's sweep of a shaded bounce, alone
OPS_SWEEP_NEE = 25  # + its env-NEE term and record
# + the light-NEE term (the emission's weight, the BRDF factor, the three
# cotangents) and the third key's sums
OPS_SWEEP_LIGHT = 50
OPS_RAY = 90  # a primary ray made in the kernel (camera_ray; logf x 2)
# the sky pass (csrc/sky.cu): a ray's lookup (normalize, atan2 and acos as
# ~20 each, two bilinear lookups of 3 channels and the blend, the MIS
# weight), and the backward's taps (eight shares of three channels, the
# level's cotangent) and their sums
OPS_SKY = 200
OPS_SKY_BWD = 150
# int32 operations of the Owen-scrambled Sobol sampler (path_common.cuh:
# u32_hash 9, hash_combine 5, owen_core 10, the dimension-1 butterfly 15,
# a bit reversal 1): a 2D draw 71, a 1D draw 31
OPS_INT_SHADE = 2 * 71 + 31  # a shaded bounce: two 2D draws and one 1D
OPS_INT_NEE = 71  # + the env draw's 2D draw
OPS_INT_LNEE = 71 + 31  # + light NEE's 2D and 1D draws
OPS_INT_RAY = 2 * 71 + 12  # a primary ray: two 2D draws, seed and index
# H100 SXM: fp32 (an FMA counted as two), HBM3. An int32 operation is
# counted as two fp32 operations: -fmad=false kernels issue no FMA, and
# int32 issues on half the lanes.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# (registers, spill-store bytes) of every variant that the parent of the
# light-NEE variants (B1e) built, read from its nvcc `-Xptxas -v` output
# (`kernel_times.py --tree` of that commit): the variants that include
# the bounce body must keep them, so the switch that B1e added compiles
# away where it is off
RESOURCES_BEFORE_B1E = {
    "B1a": (72, 0), "B1b": (89, 0), "B1c": (94, 0), "B1b+c": (96, 0),
    "B1d": (84, 0), "B1b+d": (88, 0), "B1c+d": (92, 0), "B1b+c+d": (94, 0),
    "B2": (79, 0), "B2 global": (80, 0), "B2+d": (78, 0),
    "B2+d global": (79, 0), "B2b": (88, 0), "B2b global": (88, 0),
    "B2b+c": (88, 0), "B2b+c global": (88, 0), "B2b+c+d": (94, 0),
    "B2b+c+d global": (95, 0), "B2b+c+n": (125, 0),
    "B2b+c+n global": (127, 0), "B2b+c+n+d": (96, 20),
    "B2b+c+n+d global": (96, 20), "B2b+d": (94, 0), "B2b+d global": (95, 0),
    "B2c": (79, 0), "B2c global": (80, 0), "B2c+d": (78, 0),
    "B2c+d global": (79, 0), "B2c+n": (95, 0), "B2c+n global": (96, 0),
    "B2c+n+d": (95, 0), "B2c+n+d global": (95, 0), "B3": (48, 0),
}
# Where the replay's own code changed since: the sweep's arithmetic and
# the env-NEE record's weight moved into functions shared with the record
# route's sweep (csrc/adjoint.cu `sweep_bounce`, `store_nee_weight`), the
# same operations in the same order; ptxas then allocates one register
# fewer to the brute tier's B2b+c+n and one more to its global route. The
# forward variants, which the record switch must leave alone, are not here.
RESOURCES_SINCE_SHARED_SWEEP = {
    "B2b+c+n": (124, 0), "B2b+c+n global": (128, 0),
}
# Where the bounce body's arithmetic changed since: a normalization and
# Russian roulette's 1/p divide, as the plain version and the JAX package
# do, where they multiplied by the reciprocal (csrc/geometry.cuh
# `normalize3`, csrc/path_common.cuh); the hit's normal is normalized once,
# for the winner. ptxas then allocates these one or two registers more.
RESOURCES_SINCE_DIVISION = {
    "B1b+c+d": (96, 0), "B2": (80, 0), "B2b global": (89, 0),
    "B2b+c global": (89, 0), "B2c": (80, 0),
}


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


def _record_vs_plain(sc, st, sub, rec, out_sub) -> dict:
    """The kernel's record `rec` of the rays `sub` (origin, direction,
    far, sample index, seed) against `record_transcript_reference`, on the
    rays whose forward outputs `out_sub` agree with the plain version's at
    phase 11's tolerance (all but the continuation pdf): those rays
    (`agree`), how many of them differ in ids or masks (`ids`) and in a
    float past 1e-4 + 1e-4 |plain| (`floats`), the floats' largest
    |diff| / (1 + |plain|) (`err`), and where floats differ (`drift`): for
    those rays the first slot that differs, as bounces before the path's
    last; whether t alone differs there; which words differ there (the
    attenuation, t, the env-NEE words nq and ngw, the light-NEE words lq:
    rays a word); |dt| / (1 + t) there, and the largest at the slots
    before it."""
    import torch
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk

    out_p = mk.trace_color_fused_reference(sc, *sub, st)
    cols = [c for c in range(out_p.shape[1]) if c != 10]
    agree = ((out_sub[:, cols] - out_p[:, cols]).abs()
             <= PARITY_TOL + PARITY_TOL * out_p[:, cols].abs()).all(dim=1)
    ref = adj.record_transcript_reference(sc, *sub, st)
    n_sh = rec.end.to(torch.int64) & 0xFFFF
    ids_apart = agree & (rec.end != ref.end)
    first = torch.full_like(n_sh, -1)
    t_only = torch.zeros_like(agree)
    # at the first slot: a 1, t 2, nq 4, ngw 8, lq 16
    words = torch.zeros_like(n_sh)
    dt = torch.zeros((st.max_bounces + 1, agree.shape[0]),
                     device=agree.device)
    err = 0.0
    for k in range(st.max_bounces + 1):
        live = agree & (n_sh > k)
        if not bool(live.any()):
            continue
        ids_apart |= live & (rec.word[k] != ref.word[k])
        if rec.texel is not None:
            ids_apart |= live & (rec.texel[k] != ref.texel[k])
        t_bad = torch.zeros_like(agree)
        other_bad = torch.zeros_like(agree)
        bad = torch.zeros_like(n_sh)
        for j, (a, b) in enumerate(((rec.a, ref.a), (rec.nq, ref.nq),
                                    (rec.ngw, ref.ngw), (rec.lq, ref.lq))):
            if a is None:
                continue
            a, b = a[k], b[k]
            out = (a - b).abs() > PARITY_TOL + PARITY_TOL * b.abs()
            if j == 0:
                t_bad = out[:, 3]
                out = out[:, 0:3]
                bad |= t_bad.to(torch.int64) * 2
            other_bad |= out.any(dim=1)
            bad |= out.any(dim=1).to(torch.int64) * (1, 4, 8, 16)[j]
            err = max(err, float(((a - b).abs() / (1.0 + b.abs()))[live]
                                 .max()))
        dt[k] = torch.where(live, (rec.a[k, :, 3] - ref.a[k, :, 3]).abs()
                            / (1.0 + ref.a[k, :, 3].abs()), 0.0)
        new = live & (t_bad | other_bad) & (first < 0)
        t_only = torch.where(new, t_bad & ~other_bad, t_only)
        words = torch.where(new, bad, words)
        first = torch.where(new, k, first)
    rays = torch.nonzero(first >= 0).flatten().tolist()
    drift = {"rays": len(rays),
             "t_alone": int(t_only[first >= 0].sum()),
             "words": {w: int(((words[first >= 0] & bit) != 0).sum())
                       for w, bit in (("attenuation", 1), ("t", 2),
                                      ("nq", 4), ("ngw", 8), ("lq", 16))}}
    if rays:
        k = first[rays]
        at = dt[k, rays]
        before = torch.stack([dt[:int(kk), r].max() if int(kk) else
                              dt.new_zeros(()) for kk, r in zip(k, rays)])
        drift.update(bounces_before_the_last=sorted(
            int(x) for x in (n_sh[rays] - 1 - k)),
            dt_rel=[float(at.min()), float(at.max())],
            dt_rel_before_max=float(before.max()))
    return dict(agree=agree, ids=int(ids_apart.sum()),
                floats=len(rays), err=err, drift=drift,
                floats_past_nee=int(((words[first >= 0] & 3) != 0).sum()))


def _resources(log: str) -> dict:
    """Registers and spill-store bytes of every kernel variant, from
    nvcc's `-Xptxas -v` output: {name: (registers, spill bytes)}."""
    names = {"megakernel_light_recordILb0ELb0EE": "B1e record",
             "megakernel_light_recordILb1ELb0EE": "B1b+e record",
             "megakernel_light_recordILb0ELb1EE": "B1c+e record",
             "megakernel_light_recordILb1ELb1EE": "B1b+c+e record",
             "megakernel_bvh_light_recordILb0ELb0EE": "B1e+d record",
             "megakernel_bvh_light_recordILb1ELb0EE": "B1b+e+d record",
             "megakernel_bvh_light_recordILb0ELb1EE": "B1c+e+d record",
             "megakernel_bvh_light_recordILb1ELb1EE": "B1b+c+e+d record",
             "megakernel_recordILb0ELb0EE": "B1a record",
             "megakernel_recordILb1ELb0EE": "B1b record",
             "megakernel_recordILb0ELb1EE": "B1c record",
             "megakernel_recordILb1ELb1EE": "B1b+c record",
             "megakernel_bvh_light_probeILb0EE": "B1e+d probe",
             "megakernel_bvh_light_probeILb1EE": "B1b+e+d probe",
             "megakernel_light_probeILb0EE": "B1e probe",
             "megakernel_light_probeILb1EE": "B1b+e probe",
             "megakernel_bvh_recordILb0ELb0EE": "B1d record",
             "megakernel_bvh_recordILb1ELb0EE": "B1b+d record",
             "megakernel_bvh_recordILb0ELb1EE": "B1c+d record",
             "megakernel_bvh_recordILb1ELb1EE": "B1b+c+d record",
             "megakernel_lightILb0ELb0EE": "B1e",
             "megakernel_lightILb1ELb0EE": "B1b+e",
             "megakernel_lightILb0ELb1EE": "B1c+e",
             "megakernel_lightILb1ELb1EE": "B1b+c+e",
             "megakernel_bvh_lightILb0ELb0EE": "B1e+d",
             "megakernel_bvh_lightILb1ELb0EE": "B1b+e+d",
             "megakernel_bvh_lightILb0ELb1EE": "B1c+e+d",
             "megakernel_bvh_lightILb1ELb1EE": "B1b+c+e+d",
             "megakernelILb0ELb0EE": "B1a", "megakernelILb1ELb0EE": "B1b",
             "megakernelILb0ELb1EE": "B1c", "megakernelILb1ELb1EE": "B1b+c",
             "megakernel_bvhILb0ELb0EE": "B1d",
             "megakernel_bvhILb1ELb0EE": "B1b+d",
             "megakernel_bvhILb0ELb1EE": "B1c+d",
             "megakernel_bvhILb1ELb1EE": "B1b+c+d",
             "traverse_kernel": "B3", "sky_forward": "sky forward",
             "sky_backward_taps": "sky backward",
             "sky_radix_count": "sky ordering count",
             "sky_radix_scan": "sky ordering scan",
             "sky_radix_scatter": "sky ordering scatter",
             "sky_reduce_texels": "sky backward sums"}

    def adjoint_name(mangled):
        """adjoint_kernel<kTransmissive, kSmemTranscript, kBvh, kEnv>: B2
        or B2b; c with the sky, +n with env NEE; +d on the BVH tier;
        " global" with the transcript in device memory. adjoint_sweep<
        kTransmissive, kEnv, kLight>: the record route's sweep, one kernel
        for both tiers' variants, " sweep" (`sweep_name`); +l with
        area-light NEE (B2+l)."""
        def variant(t, env):
            return ("B2b" if t else "B2") + (("+c" if t else "c") if env
                                              else "") + ("+n" if env == 2
                                                          else "")
        m = re.search(r"adjoint_sweepILb(\d)ELi(\d)ELb(\d)EE", mangled)
        if m:
            t, env, light = (int(x) for x in m.groups())
            return sweep_name(variant(t, env) + ("+l" if light else ""))
        m = re.search(r"adjoint_kernelILb(\d)ELb(\d)ELb(\d)ELi(\d)E",
                      mangled)
        if not m:
            return None
        t, smem, bvh, env = (int(x) for x in m.groups())
        return variant(t, env) + ("+d" if bvh else "") + (
            "" if smem else " global")

    out, cur, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = adjoint_name(m.group(1)) or next(
                (v for k, v in names.items() if k in m.group(1)), None)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), spill)
    return out


def sweep_name(variant: str) -> str:
    """The record route's sweep of an adjoint variant, in `_resources`'
    names: one kernel serves both tiers, so "B2b+d" and "B2b" share "B2b
    sweep"."""
    return variant.removesuffix("+d") + " sweep"


def _path_work(scene, o, d, far, sidx, seed, st) -> dict:
    """What the kernel's path needs on these rays, counted by the lockstep
    on the card with its closest hits brute-forced (or, for a BVH-tier
    scene, walked by B3, whose counters give the walk's tests): ray-bounce
    intersections, shaded bounces, env-NEE and light-NEE shadow rays (the
    lanes whose draw faces an opaque surface, as the kernel's; for light
    NEE an upper bound, which counts also the draws the kernel refuses
    before its ray: the light itself, a grazing cosine), and the
    triangle, box and sphere tests. A shadow ray's walk is counted as an
    unbounded closest-hit walk, an upper bound on the kernel's any-hit or
    bounded walk."""
    import torch

    import halogen_tpu_torch.integrator.trace as tr
    from halogen_tpu_torch.config import Intersector
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.kernels import traverse

    bvh, nee = mk.uses_bvh(scene), tr._use_nee(scene, st)
    lnee = tr._use_light_nee(scene, st)
    calls = 1 + int(nee) + int(lnee)  # intersections a bounce
    w = dict(rays=0, shaded=0, shadow=0, lshadow=0, tri=0, box=0)
    state = {"calls": 0, "bounces": 0}
    isect0, walk0 = tr.intersect_scene, traverse.traverse_world

    def walk(wbvh, origin, direction, seed_):
        out = walk0(wbvh, origin, direction, seed_)
        w["tri"] += int(out[5][state["mask"]].sum())
        w["box"] += int(out[6][state["mask"]].sum())
        return out

    def isect(sc, origin, direction, far_, settings):
        call = state["calls"] % calls
        shadow = call > 0
        kind = "lshadow" if call == calls - 1 and lnee and shadow else (
            "shadow" if shadow else "rays")
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
        w[kind] += n
        if not shadow:
            state["hit"], state["shaded"] = hit, mask & (hit.t < far_)
            w["shaded"] += int(state["shaded"].sum())
            state["bounces"] = state["bounces"] + mask.to(torch.int32)
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
    w["sphere"] = (w["rays"] + w["shadow"] + w["lshadow"]) * scene.num_spheres
    # a warp without refill stays for its longest path: the mean trips of
    # a ray, and of each 32 consecutive rays' longest
    trips = state["bounces"].to(torch.float32)
    w["mean_bounces"] = float(trips.mean())
    w["mean_warp_max"] = float(
        trips[:trips.shape[0] // 32 * 32].reshape(-1, 32).max(dim=1)
        .values.mean())
    return w


def _bound(n_bytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the least time of the work on an H100 SXM,
    the larger of its bytes over 3.35 TB/s and its fp32 operations over
    67 TFLOP/s (the H100 SXM's peak memory rate and fp32 rate)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def _path_ops(w: dict, glass: bool, nee: bool, adjoint: bool = False,
              makes_rays: int = 0, lnee: bool = False):
    """fp32-equivalent operations of the work `w` (an int32 operation as
    two); `makes_rays`: the primary rays the launch makes itself; `lnee`:
    light NEE's draw and weights on every shaded bounce (its shadow rays'
    tests are in w)."""
    shade = (OPS_SHADE + (OPS_GLASS if glass else 0) + (OPS_NEE if nee
             else 0) + (OPS_ADJ if adjoint else 0)
             + (OPS_LNEE if lnee else 0))
    ints = (w["shaded"] * (OPS_INT_SHADE + (OPS_INT_NEE if nee else 0)
                           + (OPS_INT_LNEE if lnee else 0))
            + makes_rays * OPS_INT_RAY)
    return (w["tri"] * OPS_TRI + w["box"] * OPS_BOX
            + w["sphere"] * OPS_SPHERE + w["shaded"] * shade
            + makes_rays * OPS_RAY + 2 * ints)


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


def _profile_step(fn, step_ms: float) -> dict:
    """One call of `fn` (a frame or a step) under `torch.profiler`: the
    `cudaLaunchKernel` calls, the device-side operations (kernels, copies
    and memsets), the launches of the port's own kernels, the device's busy
    time and its idle share of `step_ms`, the step's unprofiled time."""
    import torch
    from halogen_tpu_torch.profile_frame import _self_device_us

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    on_device = [r for r in rows if _self_device_us(r) > 0]
    busy_ms = sum(_self_device_us(r) for r in on_device) / 1e3
    own = ("megakernel<", "megakernel_bvh<", "megakernel_light<",
           "megakernel_bvh_light<", "megakernel_bvh_record<",
           "megakernel_record<", "megakernel_bvh_light_probe<",
           "megakernel_light_record<", "megakernel_bvh_light_record<",
           "adjoint_kernel<", "adjoint_sweep<",
           "traverse_kernel", "sky_forward", "sky_backward_taps",
           "sky_radix_", "sky_reduce_texels", "lane_sum", "sum_groups")
    return dict(
        cuda_launches=sum(r.count for r in rows
                          if r.key.startswith("cudaLaunchKernel")),
        device_ops=sum(r.count for r in on_device),
        kernel_launches=sum(r.count for r in on_device
                            if any(k in r.key for k in own)),
        busy_ms=busy_ms, profiled_ms=profiled_ms,
        idle_share=1.0 - busy_ms / step_ms)


def _profile_text(p: dict) -> str:
    return (f"a profiled one: {p['cuda_launches']} cudaLaunchKernel calls, "
            f"{p['device_ops']} device operations, {p['kernel_launches']} "
            f"launches of the port's kernels, device busy "
            f"{p['busy_ms']:.3f} ms, idle share {p['idle_share']:.3f} "
            f"(profiled {p['profiled_ms']:.1f} ms)")


def _views():
    import halogen_tpu_torch as ht

    D = ht.DebugMode
    return (D.ALBEDO, D.NORMAL, D.RAY_TRIANGLE_TESTS, D.RAY_BOX_TESTS,
            D.COMBINED)


def phase37(dev, card: str) -> dict:
    """37. Debug views on the card (the lockstep, with B3 above
    `brute_force_max_tris`) against the port's CPU render of the same
    settings through the same route; B3's per-ray counts against the
    plain walk; the testing scene's box view at 512x512."""
    import numpy as np
    import torch

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.integrator.trace import group_rays, trace_rays
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.kernels import traverse
    from halogen_tpu_torch.scene import cornell, meshes, testing_scene

    t37 = time.perf_counter()
    cpu = torch.device("cpu")
    D = ht.DebugMode
    base = dict(width=64, height=64, samples_per_pixel=1,
                ray_chunk_size=262144)
    cases = {  # name: (builder, camera, settings on the card, on the CPU)
        "cornell glossy (BRUTE)": (
            lambda d: cornell.cornell_box(glossy=True).build(device=d),
            CAM, ht.RenderSettings(**base, max_bounces=4),
            ht.RenderSettings(**base, max_bounces=4)),
        "glass dragon (AUTO: B3)": (
            lambda d: meshes.glass_dragon_scene().build(device=d),
            DRAGON_CAM, ht.RenderSettings(**base, max_bounces=4),
            ht.RenderSettings(**base, max_bounces=4,
                              intersector=ht.Intersector.PALLAS)),
        "glass dragon (PALLAS: B3)": (
            lambda d: meshes.glass_dragon_scene().build(device=d),
            DRAGON_CAM, ht.RenderSettings(
                **base, max_bounces=4, intersector=ht.Intersector.PALLAS),
            ht.RenderSettings(**base, max_bounces=4,
                              intersector=ht.Intersector.PALLAS)),
    }
    out37, on_cpu = {}, {}  # the CPU's renders, by scene and settings
    for name, (build, cam_kw, st_k, st_c) in cases.items():
        scenes = {d: build(d) for d in (dev, cpu)}
        cams = {d: ht.make_camera(**cam_kw, device=d) for d in (dev, cpu)}
        key = (cam_kw["position"], st_c)
        # every pixel's one ray through the lockstep on each device: where
        # the first hit and the path's outputs agree, the views must too
        pix = {d: torch.arange(st_k.num_pixels, device=d) for d in (dev, cpu)}
        o, dd, s, e = group_rays(cams[dev], st_k, 1, pix[dev], 0, 1)
        k = trace_rays(scenes[dev], o, dd, cams[dev].far.expand(o.shape[0]),
                       s, e, st_k.replace(debug_mode=D.COMBINED))
        if key not in on_cpu:
            o, dd, s, e = group_rays(cams[cpu], st_c, 1, pix[cpu], 0, 1)
            on_cpu[key] = {"traced": trace_rays(
                scenes[cpu], o, dd, cams[cpu].far.expand(o.shape[0]), s, e,
                st_c.replace(debug_mode=D.COMBINED))}
            for view in _views():
                on_cpu[key][view] = ht.render_frame(
                    scenes[cpu], cams[cpu], st_c.replace(debug_mode=view), 1)
        c = on_cpu[key]["traced"]
        tk, tc = k.first_hit_t.cpu().numpy(), c.first_hit_t.numpy()
        first_ok = (np.isinf(tk) & np.isinf(tc)) | np.isclose(
            tk, tc, atol=1e-5, rtol=1e-5)
        outs_ok = (np.abs(k.outputs.cpu().numpy() - c.outputs.numpy())
                   <= PARITY_TOL + PARITY_TOL * np.abs(c.outputs.numpy())
                   ).all(axis=1)
        agree = first_ok & outs_ok
        counts_eq = {key: int((getattr(k, key).cpu().numpy()[agree]
                               != getattr(c, key).numpy()[agree]).sum())
                     for key in ("tri_tests", "box_tests")}
        views = {}
        for view in _views():
            mk.LAUNCHES = traverse.LAUNCHES = 0
            img_k = ht.render_frame(scenes[dev], cams[dev],
                                    st_k.replace(debug_mode=view), 1)
            torch.cuda.synchronize()
            launched = (mk.LAUNCHES, traverse.LAUNCHES)
            img_c = on_cpu[key][view]
            a = img_k.reshape(-1, 3).cpu().numpy()
            b = img_c.reshape(-1, 3).numpy()
            assert np.isfinite(a).all(), (name, view)
            if view in (D.ALBEDO, D.NORMAL):
                bad = ~(np.abs(a - b) <= 1e-5).all(axis=1)
            else:
                bad = ~(a == b).all(axis=1)
            views[view.name] = dict(apart=int(bad[agree].sum()),
                                    apart_anywhere=int(bad.sum()),
                                    launches=launched)
            assert launched[0] == 0, "a debug view launched the megakernel"
            if scenes[dev].num_triangles > st_k.brute_force_max_tris:
                assert launched[1] > 0, "the debug view did not launch B3"
            else:
                assert launched[1] == 0, launched
            assert views[view.name]["apart"] == 0, (name, view.name)
        n = agree.shape[0]
        out37[name] = dict(pixels=n, first_hit_apart=int((~first_ok).sum()),
                           path_apart=int((~agree).sum()),
                           counts_apart=counts_eq, views=views)
        print(f"[37] {name}, 64x64 1 spp, {st_k.max_bounces} bounces: "
              f"{int((~first_ok).sum())} pixels whose first hits disagree "
              f"with the CPU's, {int((~agree).sum())} whose path outputs "
              f"do (of {n}); on the rest the per-ray counts apart "
              f"{counts_eq}; views (pixels apart where the paths agree, "
              f"anywhere; megakernel and B3 launches): {views}", flush=True)
        assert (~agree).sum() <= 0.01 * n, name
        assert not any(counts_eq.values()), name

    # B3's per-ray counts at the glass dragon's launch shape vs the walk
    dragon = meshes.glass_dragon_scene().build(device=dev)
    dcam = ht.make_camera(**DRAGON_CAM, device=dev)
    st_d = ht.RenderSettings(width=512, height=512, samples_per_pixel=1)
    pix = torch.arange(st_d.num_pixels, device=dev)
    o, d, _, _ = group_rays(dcam, st_d, 1, pix, 0, 1)
    seed = torch.full((o.shape[0],), float("inf"), device=dev)
    got = traverse._launch(dragon.wbvh, o, d, seed)
    t0 = time.perf_counter()
    ref = traverse.traverse_world_walk_reference(dragon.wbvh, o, d, seed)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    apart = {key: int((a != b).sum()) for key, a, b in zip(
        ("t", "tri", "u", "v", "sign", "tri_tests", "box_tests"), got, ref)}
    print(f"[37] B3 vs traverse_world_walk_reference on the glass dragon's "
          f"{o.shape[0]} camera rays (every ray; the plain walk took "
          f"{walk_s:.2f} s on the card): rays apart per output {apart}; "
          f"mean tests a ray: {float(got[5].float().mean()):.3f} triangles, "
          f"{float(got[6].float().mean()):.3f} boxes", flush=True)
    assert not any(apart.values()), "B3's walk differs from the plain walk"

    # the testing scene's box view at 512x512, 1 spp
    testing = testing_scene.testing_scene(False).build(device=dev)
    tcam = testing_scene.testing_scene_camera(device=dev)
    st_t = ht.RenderSettings(width=512, height=512, samples_per_pixel=1,
                             debug_mode=D.RAY_BOX_TESTS)
    ht.render_frame(testing, tcam, st_t.replace(width=64, height=64), 0)
    torch.cuda.synchronize()
    mk.LAUNCHES = traverse.LAUNCHES = 0
    t0 = time.perf_counter()
    img = ht.render_frame(testing, tcam, st_t, 1)
    torch.cuda.synchronize()
    box_ms = (time.perf_counter() - t0) * 1e3
    b3 = traverse.LAUNCHES
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0
    assert mk.LAUNCHES == 0 and b3 > 0
    out37["testing box view"] = dict(
        triangles=testing.num_triangles, ms=box_ms, b3_launches=b3,
        over_range_share=float((img == 1.0).all(dim=2).float().mean()))
    print(f"[37] testing_scene(False) ({testing.num_triangles} triangles) "
          f"RAY_BOX_TESTS 512x512 1 spp {st_t.max_bounces} bounces: "
          f"{box_ms:.1f} ms, {b3} B3 launches, "
          f"{out37['testing box view']['over_range_share']:.3f} of the "
          f"pixels past the display range; phase 37 took "
          f"{time.perf_counter() - t37:.1f} s | {card}", flush=True)
    out37["b3_vs_walk_apart"] = apart
    return out37


def phase38(dev, card: str) -> dict:
    """38. An HDRI file: a 2048-px EXR loaded by `load_envmap` lights the
    outdoors group (B1b+c); its frame against plain, the `envmap_1024`
    preset's settings at full size, and a gradient step with the mips
    against `Fused.OFF`."""
    import numpy as np
    import torch

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.diff import render_loss_grad
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.kernels import sky as skyk
    from halogen_tpu_torch.scene import hdr_io, meshes

    t38 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        hdri = hdr_io.procedural_hdri(2048)
        path = os.path.join(tmp, "sky_2048.exr")
        hdr_io.write_exr(path, hdri)
        size = os.path.getsize(path)
        env = hdr_io.load_envmap(path)
    assert np.array_equal(env.mips[0], hdri)
    scene = meshes.outdoors_scene().build(envmap=env, device=dev)
    load_s = time.perf_counter() - t38
    cam = ht.make_camera(position=(0.0, 0.6, 7.0), target=(0, -0.4, 0),
                         fov_deg=50, device=dev)
    st = ht.RenderSettings(width=1024, height=1024, samples_per_pixel=16,
                           max_bounces=4, use_envmap=True,
                           env_importance_sampling=True, env_mip_level=0,
                           ray_chunk_size=262144)
    assert scene.any_transmissive and mk.fused_supported(scene, st)
    texels = sum(int(m.shape[0] * m.shape[1]) for m in scene.env_mips)
    print(f"[38] procedural_hdri(2048) as a {size / 2**20:.1f} MiB EXR, "
          f"loaded by load_envmap: {len(scene.env_mips)} mips, {texels} "
          f"texels, the outdoors group ({scene.num_triangles} triangles, "
          f"{scene.num_spheres} spheres) built on the card in "
          f"{load_s:.2f} s", flush=True)

    small = st.replace(width=256, height=256)
    k_img = ht.render_frame(scene, cam, small, 1)
    p_img = ht.render_frame(scene, cam, small.replace(fused=ht.Fused.OFF), 1)
    rel = abs(float(k_img.mean()) - float(p_img.mean())) / abs(
        float(p_img.mean()))
    print(f"[38] 256x256 16 spp frame, kernels vs Fused.OFF: mean radiance "
          f"{float(k_img.mean()):.6f} vs {float(p_img.mean()):.6f}, rel "
          f"{rel:.2e} (< 2e-2)", flush=True)
    assert bool(torch.isfinite(k_img).all()) and rel < 2e-2

    mk.LAUNCHES = skyk.FORWARD_LAUNCHES = adj.LAUNCHES = 0
    ht.render_frame(scene, cam, st, 0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(2):
        img = ht.render_frame(scene, cam, st, f + 1)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 2
    launches = (mk.LAUNCHES, skyk.FORWARD_LAUNCHES)
    assert launches[0] > 0 and launches[1] == launches[0]
    assert bool(torch.isfinite(img).all())
    mrays = st.samples_per_pixel * st.num_pixels / dt / 1e6
    prof = _profile_step(lambda: ht.render_frame(scene, cam, st, 3),
                         dt * 1e3)
    print(f"[38] the outdoors group under the 2048-px HDRI at envmap_1024's "
          f"settings (1024x1024, 16 spp, 4 bounces, env NEE, mip level 0; "
          f"B1b+c): {launches[0]} megakernel and {launches[1]} sky "
          f"launches in 3 frames; {dt * 1e3:.2f} ms a frame = {mrays:.3f} "
          f"Mrays/s; {_profile_text(prof)} | {card}", flush=True)

    # the gradient step with the mips vs Fused.OFF (phase 15's rule, but
    # up to 1% of the pixels may round apart and be held out, not 0.1%:
    # where the roughness-0.05 metal sphere's lobe sends a ray to the
    # 2000-radiance sun, the continuation pdf at the rim of the lobe's
    # support is either ~5e5 or 0, so an ulp of direction flips the sky's
    # MIS weight between 1 and 0; the kernel's normalizations divide as
    # the plain version's do, so no ulp parts them there:
    # `perf/torch/hdri_parting.py`)
    st_g = st.replace(width=256, height=256)
    st_off = st_g.replace(fused=ht.Fused.OFF)
    p = {"materials": scene.materials, "env_mips": scene.env_mips}
    img_k = ht.render_frame(scene, cam, st_g, 1)
    img_p = ht.render_frame(scene, cam, st_off, 1)
    diff = (img_k - img_p).abs()
    agree = (diff <= PARITY_TOL + PARITY_TOL * img_p.abs()).all(
        dim=2, keepdim=True)
    n_apart = int((~agree).sum())
    rel_apart = (diff / (img_p.abs() + 1e-6)).amax(dim=2)[~agree[..., 0]]
    print(f"[38] the 256x256 forwards, kernels vs Fused.OFF: {n_apart} "
          f"pixels apart past 1e-4; their relative difference median "
          f"{float(rel_apart.median()) if n_apart else 0.0:.3e}, max "
          f"{float(rel_apart.max()) if n_apart else 0.0:.3e}", flush=True)
    assert n_apart <= 0.01 * agree.numel(), n_apart
    c = torch.rand(tuple(img_k.shape),
                   generator=torch.Generator().manual_seed(38)).to(dev)
    c = c * agree
    counts = lambda: (mk.RECORD_LAUNCHES, adj.SWEEP_LAUNCHES, adj.LAUNCHES,
                      skyk.BACKWARD_LAUNCHES, skyk.ORDER_LAUNCHES,
                      skyk.SCATTER_LAUNCHES)
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_k, g_k = render_loss_grad(p, scene, cam, st_g, img_k + c, 1)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launched = tuple(a - b for a, b in zip(counts(), before))
    t0 = time.perf_counter()
    for f in range(2):
        render_loss_grad(p, scene, cam, st_g, img_k + c, f + 2)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 2 * 1e3
    _, g_p = render_loss_grad(p, scene, cam, st_off, img_p + c, 1)
    mats = {}
    for f in ("albedo", "specular", "roughness", "emissive", "absorption"):
        mats[f], ratio = _grad_compare(getattr(g_k["materials"], f),
                                       getattr(g_p["materials"], f))
        assert ratio <= 1.0, f"the HDRI step's {f} gradient disagrees"
    mips = [(float((a - b).abs().max()), float(b.abs().max()))
            for a, b in zip(g_k["env_mips"], g_p["env_mips"])]
    assert all(bool(torch.isfinite(m).all()) for m in g_k["env_mips"])
    assert all(err <= 1e-4 * top + 1e-6 for err, top in mips), mips
    assert launched[0] > 0 and launched[1] > 0 and launched[2] == 0
    assert min(launched[3:]) > 0, launched
    print(f"[38] render_loss_grad with the mips at 256x256 16 spp "
          f"({n_apart} pixels whose forwards round apart, held out): "
          f"launches (recording megakernel, sweep, replay, sky backward, "
          f"sky ordering, sky sums) {launched}; the first step "
          f"{first_ms:.1f} ms, then {step_ms:.1f} ms a step; vs "
          f"Fused.OFF max |diff| {mats}; mips (max |diff|, max |ref|) "
          f"{mips}; phase 38 took {time.perf_counter() - t38:.1f} s | "
          f"{card}", flush=True)
    return dict(texels=texels, frame_ms=dt * 1e3, mrays_per_s=mrays,
                frame_profile=prof, mean_rel_vs_plain=rel,
                pixels_apart=n_apart, first_step_ms=first_ms,
                step_ms=step_ms, step_launches=launched,
                step_max_abs_diff=mats, mips_max_abs_diff=mips)


def _hero_args(*extra):
    """The CLI's arguments of `render --preset dragons_hero` (its scene,
    camera and settings)."""
    import argparse
    import importlib

    cli = importlib.import_module("halogen_tpu_torch.cli.main")
    p = argparse.ArgumentParser()
    cli._add_render_args(p)
    args = cli._apply_preset(p.parse_args(["--preset", "dragons_hero",
                                           *extra]))
    return cli, args


def _rank_worker(rank: int, port: int, out: str) -> int:
    """One of phase 39's two ranks on the one card (`gloo`: NCCL refuses
    two ranks on one device): dragons_hero frames over meshes (2, 1) and
    (1, 2), and a sharded gradient step twice on each, saved to `out`."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from halogen_tpu_torch.diff.grad import material_params
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.parallel import sharding

    assert sharding.init_distributed(
        backend="gloo", init_method=f"tcp://localhost:{port}",
        world_size=2, rank=rank)
    cli, args = _hero_args("--envmap")
    scene = cli._build_scene(args.scene, args.envmap, args.device)
    cam, st = cli._camera(args), cli._settings(args)
    st_g = st.replace(samples_per_pixel=16)
    zeros = torch.zeros((st.height, st.width, 3), device=scene.device)
    res = {}
    for px, spp in ((2, 1), (1, 2)):
        tag = f"{px}x{spp}"
        mesh = sharding.make_render_mesh(px, spp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = sharding.render_frame_sharded(scene, cam, st, 1, mesh)
        torch.cuda.synchronize()
        res[f"frame_s_{tag}"] = time.perf_counter() - t0
        res[f"img_{tag}"] = img.cpu().numpy()
        params = material_params(scene.materials)
        for rep in range(2):
            mk.RECORD_LAUNCHES = adj.SWEEP_LAUNCHES = adj.LAUNCHES = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, grads = sharding.loss_and_grads_sharded(
                params, scene, cam, st_g, zeros, 1, mesh)
            torch.cuda.synchronize()
            res[f"step_s_{tag}_{rep}"] = time.perf_counter() - t0
            res[f"peak_{tag}_{rep}"] = torch.cuda.max_memory_allocated()
            res[f"launches_{tag}_{rep}"] = np.array(
                [mk.RECORD_LAUNCHES, adj.SWEEP_LAUNCHES, adj.LAUNCHES])
            res[f"loss_{tag}_{rep}"] = loss.cpu().numpy()
            for k, g in grads.items():
                res[f"g_{k}_{tag}_{rep}"] = g.cpu().numpy()
    res["backend"] = np.array(dist.get_backend())
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)
    return 0


def phase39(dev, card: str) -> dict:
    """39. Sharding: two ranks on the one card over `gloo` against one
    process, then `render --preset dragons_hero --sharded` over one rank
    and `nccl`, every frame against `render_frame` bit for bit."""
    import contextlib
    import io
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from halogen_tpu_torch.diff import render_loss_grad
    from halogen_tpu_torch.integrator.trace import render_frame
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.parallel import sharding

    t39 = time.perf_counter()
    # the preset's own image is black, as the JAX CLI's: no material of
    # its three dragons and floor emits, and it leaves use_envmap off; the
    # comparisons run under its sky (`--envmap`: B1b+c+d) as well
    cli, args = _hero_args("--envmap")
    scene = cli._build_scene(args.scene, args.envmap, args.device)
    cam, st = cli._camera(args), cli._settings(args)
    st_g = st.replace(samples_per_pixel=16)
    print(f"[39] dragons_hero: {scene.num_triangles} triangles, "
          f"{scene.num_spheres} spheres, {scene.materials.count} materials, "
          f"{st.width}x{st.height} {st.samples_per_pixel} spp "
          f"{st.max_bounces} bounces, {args.frames} frames; the two ranks "
          f"under its sky (use_envmap {st.use_envmap})", flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--rank-worker", str(r), str(port), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.perf_counter() - t0
        for r, (p, o) in enumerate(zip(procs, outs)):
            assert p.returncode == 0 and f"rank {r}: OK" in o, o[-4000:]
        res = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
               for r in range(2)]

    ref_img = render_frame(scene, cam, st, 1).cpu().numpy()
    assert ref_img.max() > 0.05, "the sky-lit hero frame is black"
    zeros = torch.zeros((st.height, st.width, 3), device=dev)
    loss_ref, g_ref = render_loss_grad({"materials": scene.materials},
                                       scene, cam, st_g, zeros, 1)
    two = {}
    for tag in ("2x1", "1x2"):
        a, b = res[0][f"img_{tag}"], res[1][f"img_{tag}"]
        assert np.array_equal(a, b), f"the ranks' {tag} images differ"
        img_err = float(np.abs(a - ref_img).max())
        img_bits = bool(np.array_equal(a, ref_img))
        np.testing.assert_allclose(a, ref_img, atol=2e-5, rtol=1e-4)
        grads = {}
        for key in [k for k in res[0] if k.startswith("g_")
                    and k.endswith(f"{tag}_0")]:
            f = key[2:-len(f"_{tag}_0")]
            for r in res:
                assert np.array_equal(r[key], r[key[:-1] + "1"]), (
                    f"{key}: the rerun gave other bits")
                assert np.array_equal(r[key], res[0][key]), key
            ref = getattr(g_ref["materials"], f).cpu().numpy()
            grads[f] = float(np.abs(res[0][key] - ref).max())
            np.testing.assert_allclose(res[0][key], ref, atol=1e-4,
                                       rtol=1e-3, err_msg=f)
        loss = float(res[0][f"loss_{tag}_0"])
        np.testing.assert_allclose(loss, float(loss_ref), rtol=1e-5)
        launches = [r[f"launches_{tag}_0"].tolist() for r in res]
        for rec, sweep, replay in launches:
            assert rec > 0 and sweep > 0 and replay == 0, launches
        two[tag] = dict(
            image_max_abs_diff=img_err, image_bit_for_bit=img_bits,
            grads_max_abs_diff=grads, loss=loss, loss_ref=float(loss_ref),
            launches=launches,
            frame_s=[float(r[f"frame_s_{tag}"]) for r in res],
            step_s=[float(r[f"step_s_{tag}_1"]) for r in res],
            peak_bytes=[int(r[f"peak_{tag}_0"]) for r in res])
        print(f"[39] 2 ranks over {res[0]['backend']} on the one card, mesh "
              f"{tag}: the ranks' images equal; vs one process's "
              f"render_frame max |diff| {img_err:.3e} (bit for bit "
              f"{img_bits}); the sharded step at 16 spp on both ranks "
              f"bit for bit and repeatable, vs render_loss_grad max |diff| "
              f"{grads}, loss {loss:.8e} vs {float(loss_ref):.8e}; launches "
              f"a rank (recording forwards, sweeps, replays) {launches}; "
              f"frame s {two[tag]['frame_s']}, step s {two[tag]['step_s']}; "
              f"peak memory a rank "
              f"{[p / 2**30 for p in two[tag]['peak_bytes']]} GiB "
              f"(RECORD_SHARE {adj.RECORD_SHARE}) | {card}", flush=True)
    print(f"[39] the two ranks took {ranks_s:.1f} s with their start-up",
          flush=True)

    # one rank over nccl: the CLI's dragons_hero as the preset has it
    # (black) and under its sky, every frame captured
    one = {}
    plain_render = sharding.render_frame_sharded
    for extra in ((), ("--envmap",)):
        frames, marks = [], []

        def capture(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = plain_render(*a, **kw)
            torch.cuda.synchronize()
            marks.append(time.perf_counter() - t0)
            frames.append(img.clone())
            assert (dist.get_backend() == "nccl"
                    and dist.get_world_size() == 1)
            return img

        mk.LAUNCHES = 0
        sharding.render_frame_sharded = capture
        try:
            with tempfile.TemporaryDirectory() as tmp:
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(["render", "--preset", "dragons_hero",
                                   "--sharded", *extra, "--out",
                                   os.path.join(tmp, "hero.png")])
                cli_s = time.perf_counter() - t0
                written = any(os.path.exists(os.path.join(tmp, n))
                              for n in ("hero.png", "hero.png.npy"))
        finally:
            sharding.render_frame_sharded = plain_render
        assert rc == 0 and written and not dist.is_initialized()
        assert len(frames) == args.frames, len(frames)
        launches = mk.LAUNCHES
        _, a1 = _hero_args(*extra)
        sc1 = cli._build_scene(a1.scene, a1.envmap, a1.device)
        st1 = cli._settings(a1)
        rays = st1.samples_per_pixel * st1.num_pixels * len(frames)
        mrays = rays / sum(marks) / 1e6
        same = [bool(torch.equal(img, render_frame(sc1, cam, st1, f + 1)))
                for f, img in enumerate(frames)]
        top = max(float(img.max()) for img in frames)
        name = "under its sky" if extra else "as the preset has it"
        one[name] = dict(frames=len(frames), seconds=cli_s,
                         frame_seconds=sum(marks), mrays_per_s=mrays,
                         launches=launches, bit_for_bit=all(same),
                         max_radiance=top)
        print(f"[39] python -m halogen_tpu_torch.cli render --preset "
              f"dragons_hero --sharded {' '.join(extra)}({name}), one rank "
              f"over nccl: rc {rc}, {len(frames)} frames, {launches} "
              f"megakernel launches, {cli_s:.1f} s in all, frames "
              f"{sum(marks):.2f} s = {mrays:.3f} Mrays/s; the largest "
              f"radiance {top:.4f}; frames bit for bit with render_frame: "
              f"{sum(same)} of {len(same)} | {card}", flush=True)
        assert all(same), "a sharded frame differs from render_frame"
        assert launches > 0 and (top > 0.05 if extra else top == 0.0)
    # the scaling benchmark on the one card (the one size it has), in
    # this process over nccl, strong and weak
    from halogen_tpu_torch.parallel import scaling_bench

    bench = {}
    for extra in ((), ("--weak",)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = scaling_bench.main(["--width", "256", "--spp", "8",
                                     *extra])
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]
        assert rc == 0 and len(recs) == 1 and not dist.is_initialized()
        assert recs[0]["device"] == card, recs
        bench["weak" if extra else "strong"] = recs[0]
    print(f"[39] python -m halogen_tpu_torch.parallel.scaling_bench on one "
          f"card: {bench}; phase 39 took {time.perf_counter() - t39:.1f} s "
          f"| {card}", flush=True)
    return dict(two_ranks=two, two_ranks_s=ranks_s, one_rank=one,
                scaling_bench=bench)


def _launch_counts() -> dict:
    """The kernels' launch counts since they were last set to 0."""
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.kernels import sky as skyk
    from halogen_tpu_torch.kernels import traverse

    return {"megakernel": mk.LAUNCHES, "recording": mk.RECORD_LAUNCHES,
            "replay": adj.LAUNCHES, "sweep": adj.SWEEP_LAUNCHES,
            "B3": traverse.LAUNCHES, "sky forward": skyk.FORWARD_LAUNCHES,
            "sky backward": skyk.BACKWARD_LAUNCHES}


def _zero_launch_counts() -> None:
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.kernels import sky as skyk
    from halogen_tpu_torch.kernels import traverse

    mk.LAUNCHES = mk.RECORD_LAUNCHES = adj.LAUNCHES = 0
    adj.SWEEP_LAUNCHES = traverse.LAUNCHES = 0
    skyk.FORWARD_LAUNCHES = skyk.BACKWARD_LAUNCHES = 0


def _b3_rays(fn):
    """(fn(), the rays of each B3 launch it made, in order)."""
    from halogen_tpu_torch.kernels import traverse

    plain, rays = traverse._launch, []

    def launch(wbvh, origin, *args):
        rays.append(origin.shape[0])
        return plain(wbvh, origin, *args)

    traverse._launch = launch
    try:
        out = fn()
    finally:
        traverse._launch = plain
    return out, rays


def _busy_ms(fn) -> dict:
    """The device's busy time in `fn()` from `torch.profiler`'s CUDA
    activity alone (no host events, to keep the profile of ~24,000
    launches short), its device operations, and the seconds profiling
    took."""
    import torch
    from halogen_tpu_torch.profile_frame import _self_device_us

    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_device = [r for r in prof.key_averages() if _self_device_us(r) > 0]
    return dict(group_busy_ms=sum(_self_device_us(r)
                                  for r in on_device) / 1e3,
                group_device_ops=sum(r.count for r in on_device),
                profiler_s=time.perf_counter() - t0)


def phase40(dev, card: str) -> dict:
    """40. The wavefront scheduler on the card: the glass dragon under
    `Fused.OFF` and the testing scene's triangle view, each frame with the
    flag off and on in turns (the images equal bit for bit, B3's launches
    and rays a launch, host syncs, ms and device busy time), then a
    `Fused.OFF` gradient step on the metal dragon both ways."""
    import numpy as np
    import torch

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.diff import render_loss_grad
    from halogen_tpu_torch.integrator import trace
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.kernels import traverse
    from halogen_tpu_torch.scene import cornell, meshes, testing_scene
    from halogen_tpu_torch.scene.material import Material

    t40 = time.perf_counter()
    D = ht.DebugMode
    cases = {
        "glass dragon, Fused.OFF, 256x256 4 spp 12 bounces": (
            meshes.glass_dragon_scene().build(device=dev),
            ht.make_camera(**DRAGON_CAM, device=dev),
            ht.RenderSettings(width=256, height=256, samples_per_pixel=4,
                              max_bounces=12, fused=ht.Fused.OFF)),
        "testing_scene(False), RAY_TRIANGLE_TESTS, 512x512 1 spp": (
            testing_scene.testing_scene(False).build(device=dev),
            testing_scene.testing_scene_camera(device=dev),
            ht.RenderSettings(width=512, height=512, samples_per_pixel=1,
                              debug_mode=D.RAY_TRIANGLE_TESTS)),
    }
    out40 = {}
    for name, (scene, cam, st) in cases.items():
        flags = {"lockstep": st, "wavefront": st.replace(wavefront=True)}
        res = {k: dict(ms=[]) for k in flags}
        imgs = {}
        # four frames in turns, each timed; the first of each way is its
        # first on this scene, and counted
        for key in ("lockstep", "wavefront", "wavefront", "lockstep"):
            _zero_launch_counts()
            trace.WAVEFRONT_SYNCS = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, rays = _b3_rays(
                lambda: ht.render_frame(scene, cam, flags[key], 1))
            torch.cuda.synchronize()
            res[key]["ms"].append((time.perf_counter() - t0) * 1e3)
            if key in imgs:
                assert torch.equal(img, imgs[key]), (name, key,
                                                     "not repeatable")
                continue
            imgs[key] = img
            res[key].update(b3_launches=traverse.LAUNCHES, b3_rays=rays,
                            megakernel_launches=mk.LAUNCHES,
                            host_syncs=trace.WAVEFRONT_SYNCS)
        # device busy time of one group (a quarter of the frame): the
        # profiler takes ~0.5 ms a launch to process, ~24,000 a group
        group = torch.arange(65536, device=dev)
        # and that group's TraceOut both ways, field by field (the per-ray
        # test counts of a debug view among them)
        o, d, sidx, seed = trace.group_rays(cam, st, 1, group, 0, 1)
        far = cam.far.expand(o.shape[0])
        outs = [f(scene, o, d, far, sidx, seed, st) for f in (
            trace.trace_rays, trace.trace_rays_wavefront)]
        fields_apart = [k for k, a, b in zip(outs[0]._fields, *outs)
                        if a is not None and not torch.equal(a, b)]
        fields_compared = [k for k, a in zip(outs[0]._fields, outs[0])
                           if a is not None]
        for key, s in flags.items():
            res[key].update(_busy_ms(
                lambda: trace.render_pixels(scene, cam, s, 1, group, 0, 1)))
        equal = bool(torch.equal(imgs["lockstep"], imgs["wavefront"]))
        lock, wave = res["lockstep"], res["wavefront"]
        per_group = st.max_bounces + 1
        out40[name] = dict(bit_for_bit=equal, triangles=scene.num_triangles,
                           group_fields_apart=fields_apart,
                           **{k: {kk: vv for kk, vv in v.items()
                                  if kk != "b3_rays"} | dict(
                                      b3_rays_first_group=v["b3_rays"][
                                          :per_group])
                              for k, v in res.items()})
        print(f"[40] {name} ({scene.num_triangles} triangles): the "
              f"wavefront's image equal to the lockstep's bit for bit: "
              f"{equal}; on one group of 65,536 rays the TraceOut fields "
              f"{fields_compared} apart: {fields_apart}; B3 launches a "
              f"frame {lock['b3_launches']} -> "
              f"{wave['b3_launches']}; rays a B3 launch, the first group's "
              f"bounces: lockstep {lock['b3_rays'][:per_group]}, wavefront "
              f"{wave['b3_rays'][:per_group]}; host syncs a frame "
              f"{lock['host_syncs']} -> {wave['host_syncs']}; ms a frame "
              f"(lockstep, wavefront, wavefront, lockstep; the first two "
              f"each way's first) "
              f"{lock['ms'][0]:.1f}, {wave['ms'][0]:.1f}, "
              f"{wave['ms'][1]:.1f}, {lock['ms'][1]:.1f}; device busy in "
              f"one group of 65,536 rays {lock['group_busy_ms']:.2f} -> "
              f"{wave['group_busy_ms']:.2f} ms, device operations "
              f"{lock['group_device_ops']} -> {wave['group_device_ops']} "
              f"(profiled in {lock['profiler_s']:.1f}, "
              f"{wave['profiler_s']:.1f} s) | {card}", flush=True)
        assert equal, f"{name}: the wavefront's image differs"
        assert not fields_apart, (name, fields_apart)
        assert lock["megakernel_launches"] == wave["megakernel_launches"] == 0
        assert lock["host_syncs"] == 0 and wave["host_syncs"] > 0
        first = wave["b3_rays"][:per_group]
        assert all(a >= b for a, b in zip(first, first[1:])), first
        assert first[-1] < first[0] and 0 < wave["b3_launches"] <= (
            lock["b3_launches"]), (first, wave["b3_launches"])

    # a Fused.OFF gradient step on the 64x64 metal dragon, both ways
    box = cornell.cornell_box(with_spheres=False)
    dverts, dfaces = meshes.dragon_mesh(3)
    box.add_mesh(dverts, dfaces, Material.metal((0.9, 0.6, 0.5),
                                                roughness=0.4),
                 transform=meshes._scale_translate(0.55, (0.0, -0.45, 0.0)))
    metal = box.build(device=dev)
    mcam = ht.make_camera(**DRAGON_CAM, device=dev)
    st_g = ht.RenderSettings(width=64, height=64, samples_per_pixel=4,
                             max_bounces=12, fused=ht.Fused.OFF)
    target = torch.zeros((64, 64, 3), device=dev)
    steps, step_ms = {}, {}
    for key in ("lockstep", "wavefront"):  # a warm-up step each
        render_loss_grad({"materials": metal.materials}, metal, mcam,
                         st_g.replace(wavefront=key == "wavefront"), target,
                         1)
    for key in ("lockstep", "wavefront", "wavefront", "lockstep"):
        s = st_g.replace(wavefront=key == "wavefront")
        _zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps[key] = render_loss_grad({"materials": metal.materials}, metal,
                                      mcam, s, target, 1)
        torch.cuda.synchronize()
        step_ms.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
        assert mk.LAUNCHES == 0, "a Fused.OFF step launched the megakernel"
    (loss_a, g_a), (loss_b, g_b) = steps["lockstep"], steps["wavefront"]
    loss_equal = bool(torch.equal(loss_a, loss_b))
    worst = {}
    for f in dataclasses.fields(g_a["materials"]):
        a = getattr(g_a["materials"], f.name).cpu().numpy()
        b = getattr(g_b["materials"], f.name).cpu().numpy()
        worst[f.name] = float(np.abs(a - b).max())
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7,
                                   err_msg=f.name)
    out40["metal dragon Fused.OFF step 64x64 4 spp"] = dict(
        loss_bit_for_bit=loss_equal, loss=float(loss_a),
        grads_max_abs_diff=worst, step_ms=step_ms)
    print(f"[40] Fused.OFF render_loss_grad on the metal dragon "
          f"({metal.num_triangles} triangles), 64x64 4 spp 12 bounces, "
          f"flag off vs on (a trace that wants a gradient runs the "
          f"lockstep): "
          f"loss {float(loss_a):.8e} bit for bit {loss_equal}; gradients "
          f"max |diff| {worst} (rtol 1e-6, atol 1e-7); step ms (lockstep, "
          f"wavefront, wavefront, lockstep) {step_ms['lockstep'][0]:.1f}, "
          f"{step_ms['wavefront'][0]:.1f}, {step_ms['wavefront'][1]:.1f}, "
          f"{step_ms['lockstep'][1]:.1f}; phase 40 took "
          f"{time.perf_counter() - t40:.1f} s | {card}", flush=True)
    assert loss_equal, "the wavefront step's loss differs"
    return out40


# the one golden pixel past tests/test_golden.py's worst-pixel bound on
# the card: testing_active's (row, column) (53, 26) moves by 1.84 against
# a bound of 1.0 through every world-space route, the Fused.OFF lockstep
# too, while the JAX golden comes from the CPU's local-space walk
# (ROADMAP §C, "Spaces"; phase 18 holds the same scene's frame so)
GOLDEN_PAST_WORST = {"testing_active": {(53, 26)}}

# the JAX package's hero record (perf/hero_run.json, its
# hero_dragons_4096spp line): the image's mean radiance, not a time
JAX_HERO_MEAN_RADIANCE = 0.2344


def _light_step_scenes(dev) -> dict:
    """Phase 42's scenes: name -> (scene, camera, settings beyond the
    light-NEE flag); the sky one with both NEEs."""
    import halogen_tpu_torch as ht
    from halogen_tpu_torch.scene import cornell, meshes
    from halogen_tpu_torch.scene.envmap import Envmap
    from halogen_tpu_torch.scene.material import Material

    cam = ht.make_camera(**CAM, device=dev)
    dcam = ht.make_camera(**DRAGON_CAM, device=dev)
    box = cornell.cornell_box(with_spheres=False)
    dverts, dfaces = meshes.dragon_mesh(3)
    box.add_mesh(dverts, dfaces, Material.metal((0.9, 0.6, 0.5),
                                                roughness=0.4),
                 transform=meshes._scale_translate(0.55, (0.0, -0.45, 0.0)))
    return {
        "B1e": (cornell.cornell_box(glossy=True).build(device=dev), cam,
                dict(max_bounces=6)),
        "B1c+e": (cornell.cornell_box(glossy=True).build(
            envmap=Envmap.gradient_sky(), device=dev), cam,
            dict(max_bounces=4, use_envmap=True, env_importance_sampling=True,
                 env_mip_level=0)),
        "B1b+e+d": (meshes.glass_dragon_scene().build(device=dev), dcam,
                    dict(max_bounces=12)),
        "B1e+d": (box.build(device=dev), dcam, dict(max_bounces=6)),
    }


def phase42(dev, card: str) -> dict:
    """42. Light-NEE gradient steps past the record budget: the route that
    records each group again in its backward ('rerecord') against the
    record route bit for bit on four variants, the two full-width steps
    that the record route cannot hold, and a sharded step over one `nccl`
    rank (see the module docstring)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.diff import fit_materials, render_loss_grad
    from halogen_tpu_torch.diff.grad import material_params
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.parallel import sharding

    t42 = time.perf_counter()
    scenes = _light_step_scenes(dev)
    counts = lambda: (mk.LAUNCHES, mk.RECORD_LAUNCHES, adj.LAUNCHES,
                      adj.SWEEP_LAUNCHES)
    delta = lambda before: tuple(a - b for a, b in zip(counts(), before))

    def step(sc, cm, st, frame, params=None):
        params = params or {"materials": sc.materials}
        tgt = torch.zeros((st.height, st.width, 3), device=dev)
        return render_loss_grad(params, sc, cm, st, tgt, frame)

    def bits(a, b) -> bool:
        """Loss and every gradient of two steps equal bit for bit."""
        (la, ga), (lb, gb) = a, b
        same = torch.equal(la, lb)
        for f in dataclasses.fields(ga["materials"]):
            same &= torch.equal(getattr(ga["materials"], f.name),
                                getattr(gb["materials"], f.name))
        for x, y in zip(ga.get("env_mips", ()), gb.get("env_mips", ())):
            same &= torch.equal(x, y)
        return bool(same)

    saved = adj.RECORD_BUDGET
    variants = {}
    try:
        # the route against the record route on one step: two launches of
        # 262144 rays, under a budget of both records, then of one
        for name, (sc, cm, kw) in scenes.items():
            st = ht.RenderSettings(width=256, height=256, samples_per_pixel=8,
                                   ray_chunk_size=262144,
                                   light_importance_sampling=True, **kw)
            params = {"materials": sc.materials}
            if st.use_envmap:
                params["env_mips"] = sc.env_mips
            one = adj.record_bytes(sc, st, 262144)
            live = mk.live_record_bytes(dev)
            adj.RECORD_BUDGET = live + 2 * one
            assert adj.record_plan(sc, st, 262144, 2) == "recorded"
            before = counts()
            rec = step(sc, cm, st, 1, params)
            n_rec = delta(before)
            adj.RECORD_BUDGET = live + one
            assert adj.record_plan(sc, st, 262144, 2) == "rerecord"
            before = counts()
            rer = step(sc, cm, st, 1, params)
            n_re = delta(before)
            assert mk.live_record_bytes(dev) == live
            same = bits(rec, rer)
            variants[name] = dict(bit_for_bit=same, launches_recorded=n_rec,
                                  launches_rerecord=n_re, loss=float(rer[0]))
            print(f"[42] {name} 256x256 8 spp {st.max_bounces} bounces, two "
                  f"launches: the rerecord route (megakernel, recording, "
                  f"replay, sweep) {n_re} vs the record route {n_rec}; loss, "
                  f"gradients{' and mips' if st.use_envmap else ''} bit for "
                  f"bit {same} | {card}", flush=True)
            assert same, f"{name}: the rerecord route's bits differ"
            assert n_rec == (2, 2, 0, 2) and n_re == (4, 2, 0, 2), (n_rec,
                                                                   n_re)
            assert float(rec[1]["materials"].albedo.abs().sum()) > 0

        # phase 36's Cornell glossy light step (256x256, 256 spp, 64
        # launches, 4.29 GB of records) on each route in turns: record,
        # rerecord, rerecord, record
        sc, cm, base = scenes["B1e"]
        st = ht.RenderSettings(width=256, height=256, samples_per_pixel=256,
                               ray_chunk_size=262144,
                               light_importance_sampling=True, **base)
        live = mk.live_record_bytes(dev)
        budgets = {"recorded": None,
                   "rerecord": live + adj.record_bytes(sc, st, 262144)}
        turns = {"recorded": [], "rerecord": []}
        first = {}
        for route in ("recorded", "rerecord", "rerecord", "recorded"):
            adj.RECORD_BUDGET = budgets[route]
            assert adj.record_plan(sc, st, 262144, 64) == route
            fn = lambda f, sc=sc, cm=cm, st=st: step(sc, cm, st, f)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_bytes = torch.cuda.memory_allocated()
            _zero_launch_counts()
            out = fn(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in range(3):
                fn(f + 2)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / 3
            n = _launch_counts()
            peak = torch.cuda.max_memory_allocated() - base_bytes
            first.setdefault(route, out)
            prof = _profile_step(lambda: fn(5), dt * 1e3)
            turns[route].append(dict(step_ms=dt * 1e3, launches=n,
                                     busy_ms=prof["busy_ms"],
                                     idle_share=prof["idle_share"],
                                     cuda_launches=prof["cuda_launches"],
                                     peak_above_start_bytes=peak))
            print(f"[42] cornell_glossy_256_fwd_bwd_light on '{route}': "
                  f"{n} launches in 4 steps; step {dt * 1e3:.2f} ms; "
                  f"{_profile_text(prof)}; peak memory above the step's "
                  f"start {peak / 2**30:.3f} GiB | {card}", flush=True)
        same = bits(first["recorded"], first["rerecord"])
        assert same, "phase 36's light step: the routes' bits differ"
        print(f"[42] cornell_glossy_256_fwd_bwd_light: the two routes' "
              f"loss and gradients bit for bit {same}", flush=True)

        # the full-width steps with the default budget (a quarter of the
        # card): their records would not fit it, so they take the route
        adj.RECORD_BUDGET = None
        full = {
            "cornell_glossy_1024_256spp_fwd_bwd_light": (
                "B1e", dict(samples_per_pixel=256)),
            "glass_dragon_1024_64spp_fwd_bwd_light": (
                "B1b+e+d", dict(samples_per_pixel=64)),
        }
        steps = {}
        for name, (variant, kw) in full.items():
            sc, cm, base = scenes[variant]
            st = ht.RenderSettings(width=1024, height=1024,
                                   ray_chunk_size=262144,
                                   light_importance_sampling=True,
                                   **{**base, **kw})
            launches = st.num_pixels * st.samples_per_pixel // 262144
            one = adj.record_bytes(sc, st, 262144)
            assert adj.record_plan(sc, st, 262144, launches) == "rerecord"
            fn = lambda f, sc=sc, cm=cm, st=st: step(sc, cm, st, f)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_bytes = torch.cuda.memory_allocated()
            _zero_launch_counts()
            fn(0)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [fn(f + 1) for f in range(3)]
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / 3
            n = _launch_counts()
            peak = torch.cuda.max_memory_allocated()
            assert (n["megakernel"] == 8 * launches
                    and n["recording"] == n["sweep"] == 4 * launches
                    and n["replay"] == 0), n
            for loss, grads in outs:
                assert bool(torch.isfinite(loss)), name
                for f in dataclasses.fields(grads["materials"]):
                    g = getattr(grads["materials"], f.name)
                    assert bool(torch.isfinite(g.float()).all()), (name, f)
            same = bits(outs[0], fn(1))
            assert same, f"{name}: two calls gave other bits"
            prof = _profile_step(lambda: fn(4), dt * 1e3)
            mr = st.samples_per_pixel * st.num_pixels / dt / 1e6
            steps[name] = dict(
                step_s=dt, mrays_fwd_bwd=mr, launches=n, profile=prof,
                peak_bytes=peak, peak_above_start_bytes=peak - base_bytes,
                record_bytes_one_launch=one,
                record_bytes_record_route=launches * one,
                repeat_bit_for_bit=same)
            print(f"[42] {name} {st.width}x{st.height} "
                  f"{st.samples_per_pixel} spp {st.max_bounces} bounces "
                  f"(rerecord; the record route would keep "
                  f"{launches * one / 1e9:.1f} GB): {n} launches in 4 "
                  f"steps; step {dt:.4f} s = {mr:.3f} Mrays/s (fwd+bwd); "
                  f"{_profile_text(prof)}; peak memory {peak / 2**30:.3f} "
                  f"GiB ({(peak - base_bytes) / 2**30:.3f} GiB above the "
                  f"step's start; one launch's record "
                  f"{one / 2**20:.1f} MiB); finite gradients; two calls "
                  f"bit for bit {same} | {card}", flush=True)

        # a sharded light-NEE step over one nccl rank past the budget
        sc, cm, base = scenes["B1e"]
        st = ht.RenderSettings(width=256, height=256, samples_per_pixel=16,
                               ray_chunk_size=262144,
                               light_importance_sampling=True, **base)
        formed = sharding.init_distributed()
        try:
            mesh = sharding.make_render_mesh(1, 1)
            zeros = torch.zeros((256, 256, 3), device=dev)
            params = material_params(sc.materials)
            live = mk.live_record_bytes(dev)
            one = adj.record_bytes(sc, st, 262144)
            shard = {}
            for route, budget in (("recorded", live + 4 * one),
                                  ("rerecord", live + one)):
                adj.RECORD_BUDGET = budget
                before = counts()
                shard[route] = sharding.loss_and_grads_sharded(
                    params, sc, cm, st, zeros, 1, mesh)
                shard[route + "_launches"] = delta(before)
        finally:
            if formed:
                dist.destroy_process_group()
        adj.RECORD_BUDGET = live + one
        ref_loss, ref_g = step(sc, cm, st, 1)
        # a short fit past the budget: fit_materials takes the route too
        before = counts()
        _, fit_losses = fit_materials(sc, cm, st, zeros, steps=3)
        fit_launches = delta(before)
        print(f"[42] fit_materials, light NEE, 256x256 16 spp, 3 steps "
              f"under a budget of one launch's record: losses "
              f"{fit_losses}, launches (megakernel, recording, replay, "
              f"sweep) {fit_launches} | {card}", flush=True)
        assert np.isfinite(fit_losses).all()
        assert fit_launches == (24, 12, 0, 12), fit_launches
        (l_rec, g_rec), (l_re, g_re) = shard["recorded"], shard["rerecord"]
        same = torch.equal(l_rec, l_re) and all(
            torch.equal(g_rec[k], g_re[k]) for k in g_rec)
        vs_ref = {k: float((g_re[k] - getattr(ref_g["materials"], k))
                           .abs().max()) for k in g_re}
        ref_bits = torch.equal(l_re, ref_loss) and all(
            torch.equal(g_re[k], getattr(ref_g["materials"], k))
            for k in g_re)
        print(f"[42] loss_and_grads_sharded, light NEE, one nccl rank, "
              f"256x256 16 spp (4 launches): rerecord launches "
              f"{shard['rerecord_launches']} vs recorded "
              f"{shard['recorded_launches']}, bit for bit {same}; vs "
              f"render_loss_grad: loss {float(l_re):.8e} vs "
              f"{float(ref_loss):.8e}, max |diff| {vs_ref}, bit for bit "
              f"{ref_bits} | {card}", flush=True)
        assert same, "the sharded rerecord step's bits differ"
        assert shard["rerecord_launches"] == (8, 4, 0, 4)
        np.testing.assert_allclose(float(l_re), float(ref_loss), rtol=1e-5)
        for k in g_re:
            np.testing.assert_allclose(
                g_re[k].cpu().numpy(),
                getattr(ref_g["materials"], k).cpu().numpy(),
                atol=1e-4, rtol=1e-3, err_msg=k)
    finally:
        adj.RECORD_BUDGET = saved
    print(f"[42] phase 42 took {time.perf_counter() - t42:.1f} s", flush=True)
    return dict(variants=variants, steps=steps, cornell_256_turns=turns,
                sharded=dict(bit_for_bit_with_record_route=same,
                             vs_render_loss_grad_max_abs_diff=vs_ref,
                             bit_for_bit_with_render_loss_grad=ref_bits,
                             launches=shard["rerecord_launches"]),
                fit_losses=fit_losses, fit_launches=fit_launches)


def phase41(card: str) -> dict:
    """41. The port's scripts on the card at their default sizes, each
    writing into a temporary directory: hero_run in full, inverse_demo,
    turntable (the glass dragon), variance_bench and gen_goldens."""
    import numpy as np

    from halogen_tpu_torch.scripts import (
        gen_goldens,
        hero_run,
        inverse_demo,
        turntable,
        variance_bench,
    )

    t41 = time.perf_counter()
    out41 = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {
            "hero_run": (hero_run, ["--out-dir", tmp]),
            "inverse_demo": (inverse_demo,
                             ["--out-dir", os.path.join(tmp, "inverse")]),
            "turntable": (turntable,
                          ["--out", os.path.join(tmp, "turntable")]),
            "variance_bench": (variance_bench,
                               ["--out", os.path.join(tmp, "var.jsonl")]),
            "gen_goldens": (gen_goldens,
                            ["--out-dir", os.path.join(tmp, "golden")]),
        }
        for name, (module, argv) in runs.items():
            _zero_launch_counts()
            t0 = time.perf_counter()
            rec = module.main(argv)
            seconds = time.perf_counter() - t0
            launches = _launch_counts()
            out41[name] = dict(record=rec, seconds=seconds,
                               launches=launches)
            print(f"[41] python -m halogen_tpu_torch.scripts.{name} "
                  f"{' '.join(argv)}: {seconds:.1f} s, launches {launches} "
                  f"| {card}", flush=True)
            recs = rec if isinstance(rec, list) else [rec]
            assert all(r["device"] == card for r in recs), recs
            assert launches["megakernel"] > 0, f"{name} did not launch"
        hero = out41["hero_run"]["record"]
        dev_hero = hero["mean_radiance"] / JAX_HERO_MEAN_RADIANCE - 1.0
        out41["hero_run"]["mean_radiance_vs_jax"] = dev_hero
        inv = out41["inverse_demo"]["record"]
        tt = out41["turntable"]["record"]
        written = [os.path.exists(p) for p in tt["written"]]
        print(f"[41] hero_run: {hero['width']}² {hero['total_spp']} spp in "
              f"{hero['render_s']:.2f} s = {hero['mrays_per_s']:.1f} "
              f"Mrays/s; mean radiance {hero['mean_radiance']:.6f} against "
              f"the JAX package's recorded {JAX_HERO_MEAN_RADIANCE} "
              f"({dev_hero:+.3%}); inverse_demo held-out loss "
              f"{inv['held_out_loss_before']:.6e} -> "
              f"{inv['held_out_loss_after']:.6e}; turntable wrote "
              f"{tt['written']}; variance reduction "
              f"{[r['variance_reduction_x'] for r in out41['variance_bench']['record']]}"
              f"; goldens within bounds "
              f"{[r['within'] for r in out41['gen_goldens']['record']]}; "
              f"phase 41 took {time.perf_counter() - t41:.1f} s | {card}",
              flush=True)
        assert hero["finite"] and np.isfinite(hero["grad_step_loss"])
        assert abs(dev_hero) < 2e-2, "the hero image's mean radiance"
        assert inv["held_out_loss_after"] < inv["held_out_loss_before"], (
            "the inverse demo did not lower the held-out loss")
        assert tt["finite"] and all(written) and min(tt["view_means"]) > 0
        for r in out41["variance_bench"]["record"]:
            assert r["mse_nee_on"] < r["mse_nee_off"], r
        # a golden's worst pixel: only the pixels named in
        # GOLDEN_PAST_WORST may pass it (ROADMAP §C, "Spaces": the JAX
        # goldens come from the CPU's local-space walk); the MAE bound
        # holds for every golden
        past41 = {}
        for r in out41["gen_goldens"]["record"]:
            assert r["finite"] and r["mae"] < r["mae_tol"], r
            img = np.load(os.path.join(tmp, "golden",
                                       f"{r['name']}.npz"))["image"]
            golden = np.load(gen_goldens.JAX_GOLDENS
                             / f"{r['name']}.npz")["image"]
            over = np.abs(img - golden).max(axis=-1) >= r["worst_tol"]
            past = [tuple(p) for p in np.argwhere(over).tolist()]
            assert r["within"] == (not past), (r, past)
            if past:
                past41[r["name"]] = past
            assert set(past) <= GOLDEN_PAST_WORST.get(r["name"], set()), (
                r, past)
        out41["gen_goldens"]["past_worst_bound"] = past41
        print(f"[41] gen_goldens: pixels past the worst bound {past41}, "
              f"each of them named in GOLDEN_PAST_WORST", flush=True)
    return out41


def phase43(dev, card: str) -> dict:
    """43. The chunk node's `lane_sum` and `sum_groups` against their plain
    versions at the Cornell cells' shapes, and their launches a Cornell
    fit step and frame (see the module docstring)."""
    import numpy as np
    import torch

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.diff import render_loss_grad
    from halogen_tpu_torch.integrator.trace import _spp_block
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.profile_frame import _self_device_us
    from halogen_tpu_torch.scene import cornell
    from halogen_tpu_torch.utils import profiling

    t43 = time.perf_counter()
    lib = mk.load_library("megakernel")
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(43)
    n = 262144
    lane = {}
    for stride in (10, 12, 3):
        for sb in (1, 4, 8):
            n_pix = n // sb
            # magnitudes over many octaves, so that another order of the
            # adds shows in the bits
            src = (torch.rand((n, stride), generator=gen, device=dev)
                   * torch.exp(torch.randn((n, 1), generator=gen,
                                           device=dev) * 4))
            acc0 = torch.rand((n_pix, 3), generator=gen, device=dev)
            acc = acc0.clone()

            def kernel(acc=acc, src=src, stride=stride, n_pix=n_pix, sb=sb):
                err = lib.halogen_lane_sum(src.data_ptr(), acc.data_ptr(),
                                           stride, n_pix, sb, stream)
                assert err == 0, err

            def plain(acc0=acc0, src=src, n_pix=n_pix, sb=sb):
                return acc0 + src[:, 0:3].reshape(n_pix, sb, 3).sum(dim=1)

            kernel()
            ref = plain()
            torch.cuda.synchronize()
            assert torch.equal(acc, ref), (stride, sb)
            k_ms = [_cuda_ms(kernel, 50) for _ in range(3)]
            p_ms = [_cuda_ms(plain, 50) for _ in range(3)]
            # bytes: 12 a lane read, 12 a pixel read and 12 written
            lane[f"{stride} floats a row, {sb} lanes"] = dict(
                ms=float(np.mean(k_ms)), plain_ms=float(np.mean(p_ms)),
                bound=_bound(n * 12 + n_pix * 24, 3 * n), bit_equal=True)
    print(f"[43] lane_sum at {n} rays, bit for bit the plain sum; ms "
          f"(kernel, plain): "
          f"{ {k: (round(v['ms'], 4), round(v['plain_ms'], 4)) for k, v in lane.items()} } "
          f"| {card}", flush=True)

    # a Cornell fit step's chunk: 65536 pixels, 4 lanes a group, 64 groups
    scene = cornell.cornell_box(glossy=True).build(device=dev)
    cam = ht.make_camera(**CAM, device=dev)
    st = ht.RenderSettings(width=256, height=256, samples_per_pixel=256,
                           max_bounces=6, ray_chunk_size=262144)
    pix = torch.arange(st.num_pixels, device=dev)
    spp = st.samples_per_pixel
    sb = _spp_block(pix.shape[0], spp, st.ray_chunk_size)
    groups = spp // sb
    assert (sb, groups) == (4, 64), (sb, groups)
    tables = list(mk._scene_tables(scene))
    tables[3] = tables[3].detach().requires_grad_()
    img = mk.trace_color_chunk(scene, mk.pixel_view(cam, st, 1, pix), 0, sb,
                               groups, spp, st, tables, None, None,
                               "recorded")
    node = img.grad_fn  # the chunk node's context: its record
    mat_tab, *saved = node.saved_tensors
    it = iter(saved)
    rec = mk.Record(*(next(it) if f else None for f in node.record_fields))
    mat_tab = mat_tab.detach()
    tabs = (*tables[:3], mat_tab)
    ct = torch.randn((rec.n, 3), generator=gen, device=dev)

    def chunk():
        return adj.sweep_chunk(scene, rec, ct, st, mat_tab, groups)

    def sweeps():
        return [adj._sweep(scene, mk.Record(*(None if t is None else t[g]
                                              for t in rec)),
                           ct, st, tabs, None, None)
                for g in range(groups)]

    def plain_sum(parts):
        """The groups' [K, 12] summed as autograd adds those of one node a
        group: the newest first."""
        out = parts[-1]
        for p in reversed(parts[:-1]):
            out = out + p
        return out

    per_group = lambda: plain_sum(sweeps())
    parts = sweeps()
    got, ref = chunk(), plain_sum(parts)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    assert torch.equal(got, ref), err
    assert float(got.abs().sum()) > 0
    chunk_ms = [_cuda_ms(chunk, 3) for _ in range(3)]
    plain_ms = [_cuda_ms(per_group, 3) for _ in range(3)]
    sum_plain_ms = [_cuda_ms(lambda: plain_sum(parts), 20) for _ in range(3)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        chunk()
        torch.cuda.synchronize()
    rows = {r.key: r for r in prof.key_averages()
            if _self_device_us(r) > 0}
    sg = [r for k, r in rows.items() if "sum_groups" in k]
    assert len(sg) == 1 and sg[0].count == 1, list(rows)
    sum_ms = _self_device_us(sg[0]) / 1e3
    chunk_dev_ms = sum(_self_device_us(r) for r in rows.values()) / 1e3
    k = scene.materials.count
    sweep = dict(groups=groups, rays=rec.n, max_abs_err=err,
                 ms=float(np.mean(chunk_ms)),
                 plain_ms=float(np.mean(plain_ms)),
                 chunk_device_ms=chunk_dev_ms, sum_groups_device_ms=sum_ms,
                 sum_plain_ms=float(np.mean(sum_plain_ms)),
                 bound=_bound(4 * 12 * k * (groups + 1), 12 * k * groups))
    print(f"[43] sweep_chunk over a fit step's 64 groups of {rec.n} rays: "
          f"bit for bit each group's _sweep summed last first; "
          f"{sweep['ms']:.3f} ms (device {chunk_dev_ms:.3f} ms, sum_groups "
          f"{sum_ms * 1e3:.2f} us) vs {sweep['plain_ms']:.3f} ms a group at "
          f"a time | {card}", flush=True)
    del img, node, saved, rec, it, parts

    # the launches of a Cornell fit step and of a Cornell frame
    names = ("megakernel.chunk_nodes", "megakernel.chunk_groups",
             "megakernel.lane_sums", "adjoint.group_sums",
             "megakernel.launches", "adjoint.sweep_launches")
    st_f = ht.RenderSettings(width=512, height=512, samples_per_pixel=32,
                             max_bounces=6, ray_chunk_size=262144)
    target = torch.zeros((256, 256, 3), device=dev)
    runs = {
        "fit step": lambda: render_loss_grad({"materials": scene.materials},
                                             scene, cam, st, target, 2),
        "frame": lambda: ht.render_frame(scene, cam, st_f, 2)}
    launches = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        c0 = profiling.counts()
        fn()
        torch.cuda.synchronize()
        c1 = profiling.counts()
        launches[name] = {k: c1[k] - c0[k] for k in names}
    want = {"fit step": (1, 64, 64, 1, 64, 64), "frame": (1, 32, 32, 0, 32, 0)}
    for name, w in want.items():
        assert tuple(launches[name][k] for k in names) == w, (name, launches)
    print(f"[43] launches {launches}; phase 43 took "
          f"{time.perf_counter() - t43:.1f} s | {card}", flush=True)
    return dict(lane=lane, sweep=sweep, launches=launches)


def phase44(dev, card: str) -> dict:
    """44. The chunk node under the sky at `testing_fit`'s size against a
    node a group, and the sums' add mode (see the module docstring)."""
    import weakref

    import numpy as np
    import torch

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.diff.grad import (
        FLOAT_MATERIAL_FIELDS,
        render_with_params,
        with_material_params,
    )
    from halogen_tpu_torch.integrator.trace import _spp_block
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.kernels import sky as skyk
    from halogen_tpu_torch.scene import hdr_io, testing_scene
    from halogen_tpu_torch.scene.envmap import Envmap
    from halogen_tpu_torch.utils import profiling

    t44 = time.perf_counter()
    env = Envmap.from_equirect(hdr_io.procedural_hdri(4096))
    scene = testing_scene.testing_scene(False).build(envmap=env, device=dev)
    n_texels = sum(int(m.shape[0] * m.shape[1]) for m in scene.env_mips)
    assert (len(scene.env_mips), n_texels) == (6, 11182080), n_texels

    # the sums' add mode at the atlas: out + the fresh sums, bit for bit
    gen = torch.Generator(device=dev).manual_seed(44)
    m = 259200 * skyk.TAPS
    keys = torch.randint(-1, n_texels // 3, (m,), generator=gen, device=dev,
                         dtype=torch.int32)
    wts = torch.randn((m, 3), generator=gen, device=dev)
    buf = torch.randn((n_texels, 3), generator=gen, device=dev)
    fresh = skyk.scatter_texels(keys, wts, n_texels)
    added = skyk.scatter_texels(keys, wts, n_texels, out=buf.clone())
    torch.cuda.synchronize()
    hit = torch.zeros((n_texels,), dtype=torch.bool, device=dev)
    hit[keys[keys >= 0].long()] = True
    assert torch.equal(added, buf + fresh)
    assert torch.equal(added[~hit], buf[~hit])
    add_mode = dict(taps=m, texels_hit=int(hit.sum()), bit_equal=True)
    print(f"[44] the sums' add mode at {n_texels} texels, {m} taps: "
          f"bit for bit buffer + the fresh sums, {int((~hit).sum())} "
          f"texels without a tap untouched | {card}", flush=True)
    del keys, wts, buf, fresh, added, hit

    spec = testing_scene.load_fixture()["cameras"][0]
    world = np.asarray(spec["world"], np.float32).reshape(4, 4)
    pos = world[:3, 3]
    cam = ht.make_camera(position=tuple(pos), target=tuple(pos + world[:3, 2]),
                         up=tuple(world[:3, 1]), fov_deg=spec["fov_deg"],
                         aspect=480 / 270, near=spec["near"],
                         far=spec["far"], device=dev)
    st = ht.RenderSettings(width=480, height=270, samples_per_pixel=64,
                           max_bounces=12, max_diffuse_bounces=4,
                           max_glossy_bounces=4, max_transmission_bounces=12,
                           filter_radius=1.0, use_envmap=True,
                           env_mip_level=1, ray_chunk_size=262144)
    sb = _spp_block(st.num_pixels, st.samples_per_pixel, st.ray_chunk_size)
    groups = st.samples_per_pixel // sb
    assert (sb, groups, adj.env_mode(scene, st)) == (2, 32, 1)
    target = torch.full((270, 480, 3), 0.25, device=dev)
    names = ("sky.atlas_builds", "megakernel.chunk_nodes",
             "megakernel.launches", "sky.backward_launches")

    def step(frame, chunk):
        leaves = {f: getattr(scene.materials, f).detach().clone()
                  .requires_grad_(True) for f in FLOAT_MATERIAL_FIELDS}
        mips = [x.detach().clone().requires_grad_(True)
                for x in scene.env_mips]
        built, real, serves = [], skyk.atlas, mk.chunk_serves

        def atlas(env_mips):
            tex = real(env_mips)
            built.append(weakref.ref(tex))
            return tex

        skyk.atlas = atlas
        if not chunk:
            mk.chunk_serves = lambda *args: False
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            c0 = profiling.counts()
            t0 = time.perf_counter()
            params = {"materials": with_material_params(scene.materials,
                                                        leaves),
                      "env_mips": tuple(mips)}
            img = render_with_params(params, scene, cam, st, frame)
            loss = ((img - target) ** 2).mean()
            loss.backward()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            alive = sum(r() is not None for r in built)
            c1 = profiling.counts()
            peak = torch.cuda.max_memory_allocated(dev)
        finally:
            skyk.atlas, mk.chunk_serves = real, serves
        return dict(img=img.detach(), d_mat={f: t.grad for f, t in
                                             leaves.items()},
                    d_env=[x.grad for x in mips], ms=ms, alive=alive,
                    peak_gib=peak / 2**30, peak_step_gib=(peak - base) / 2**30,
                    **{k: c1[k] - c0[k] for k in names})

    def same(a, b):
        return (torch.equal(a["img"], b["img"])
                and all(torch.equal(a["d_mat"][f], b["d_mat"][f])
                        for f in FLOAT_MATERIAL_FIELDS)
                and all(torch.equal(x, y)
                        for x, y in zip(a["d_env"], b["d_env"])))

    step(1, True)  # builds, warms
    step(1, False)
    runs = {"chunk node": [], "a node a group": []}
    for chunk in (True, False, False, True):
        runs["chunk node" if chunk else "a node a group"].append(
            step(2, chunk))
    got, ref = runs["chunk node"][0], runs["a node a group"][0]
    assert same(got, runs["chunk node"][1]), "the chunk node repeats"
    equal = same(got, ref)
    gaps = dict(
        image=float((got["img"] - ref["img"]).abs().max()),
        materials=max(float((got["d_mat"][f] - ref["d_mat"][f]).abs().max())
                      for f in FLOAT_MATERIAL_FIELDS),
        mips=max(float((x - y).abs().max())
                 for x, y in zip(got["d_env"], ref["d_env"])))
    summary = {k: [{kk: vv for kk, vv in r.items()
                    if kk not in ("img", "d_mat", "d_env")} for r in v]
               for k, v in runs.items()}
    print(f"[44] a testing_fit step (480x270, 64 spp, {groups} groups, "
          f"{n_texels} texels): the chunk node "
          f"{'equals' if equal else 'DIFFERS FROM'} a node a group bit for "
          f"bit (image, {len(FLOAT_MATERIAL_FIELDS)} material fields, 6 "
          f"mips; largest gaps {gaps}); {summary} | {card}", flush=True)
    assert equal, gaps
    assert all(r["sky.atlas_builds"] == 1 and r["alive"] == 0
               and r["megakernel.chunk_nodes"] == 1
               for r in summary["chunk node"]), summary
    assert all(r["sky.atlas_builds"] == groups
               and r["megakernel.chunk_nodes"] == 0
               for r in summary["a node a group"]), summary
    assert sum(float(x.abs().sum()) for x in got["d_env"]) > 0
    print(f"[44] phase 44 took {time.perf_counter() - t44:.1f} s | {card}",
          flush=True)
    return dict(add_mode=add_mode, steps=summary, bit_equal=equal, gaps=gaps)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    t_main = time.perf_counter()
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
    from halogen_tpu_torch.kernels import sky as skyk
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
    prof6 = _profile_step(lambda: ht.render_frame(scene, cam, st, 5),
                          dt / 4 * 1e3)
    # the kernel makes its own rays: no eager ray-generation launches (a
    # frame of 32 groups took ~33,500 launches when torch made the rays)
    assert prof6["cuda_launches"] <= 3350, prof6
    print(f"[6] main path {st.width}x{st.height} {st.samples_per_pixel} spp "
          f"{st.max_bounces} bounces: {launches} kernel "
          f"launches in 5 frames; 4 frames in {dt:.4f} s = {mrays:.3f} "
          f"Mrays/s; {_profile_text(prof6)}; plain frame "
          f"{plain_frame_s:.4f} s = "
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

    def brute_steps(tag, step, n_launches):
        """A warm-up and two timed steps of `step(frame)` on the record
        route (the brute tier records since its adjoint sweeps: 3 x
        n_launches recording forwards and sweeps, no replay), then the same
        two steps with RECORD_BUDGET = 0 (forwards and replays), whose
        losses and gradients must be equal bit for bit; each with its peak
        device memory. Returns (seconds a step, the launches (megakernel,
        replay) of the record route's three steps, the steps, peak bytes,
        the replay's (seconds a step, peak bytes))."""
        counts = lambda: (mk.LAUNCHES, mk.RECORD_LAUNCHES, adj.LAUNCHES,
                          adj.SWEEP_LAUNCHES)
        mk.LAUNCHES = adj.LAUNCHES = 0
        mk.RECORD_LAUNCHES = adj.SWEEP_LAUNCHES = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [step(f) for f in (1, 2)]
        torch.cuda.synchronize()
        dt_ = (time.perf_counter() - t0) / 2
        peak = torch.cuda.max_memory_allocated()
        launched = counts()
        assert launched == (3 * n_launches, 3 * n_launches, 0,
                            3 * n_launches), (tag, launched)
        saved = adj.RECORD_BUDGET
        adj.RECORD_BUDGET = 0
        try:
            torch.cuda.reset_peak_memory_stats()
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps = [step(f) for f in (1, 2)]
            torch.cuda.synchronize()
            dt_rep = (time.perf_counter() - t0) / 2
            peak_rep = torch.cuda.max_memory_allocated()
            launched_rep = tuple(a - b for a, b in zip(counts(), before))
        finally:
            adj.RECORD_BUDGET = saved
        assert launched_rep == (2 * n_launches, 0, 2 * n_launches, 0), (
            tag, launched_rep)
        for (loss, grads), (loss_r, grads_r) in zip(outs, reps):
            assert bool(torch.isfinite(loss)), f"{tag} loss not finite"
            assert torch.equal(loss, loss_r), tag
            for f in dataclasses.fields(grads["materials"]):
                g = getattr(grads["materials"], f.name)
                assert bool(torch.isfinite(g.float()).all()), f.name
                assert torch.equal(g, getattr(grads_r["materials"], f.name)), (
                    tag, f.name)
            for g, g_r in zip(grads.get("env_mips", ()),
                              grads_r.get("env_mips", ())):
                assert bool(torch.isfinite(g).all()), tag
                assert torch.equal(g, g_r), tag
        print(f"[{tag}] the record route's three steps: launches "
              f"(megakernel, recording, replay, sweep) {launched}, peak "
              f"memory {peak / 2**30:.3f} GiB; the same two steps with "
              f"RECORD_BUDGET = 0: {launched_rep}, "
              f"{dt_rep * 1e3:.1f} ms a step, peak "
              f"{peak_rep / 2**30:.3f} GiB; losses and gradients bit for bit "
              f"equal: True | {card}", flush=True)
        return (dt_, (launched[0], launched[3]), outs, peak,
                (dt_rep, peak_rep))

    step9 = lambda f: render_loss_grad(params, scene, cam, st9, zeros, f)
    dt9, fb_launches, steps, peak9, rep9 = brute_steps("9", step9, 64)
    dt9 *= 2  # two steps
    fb_mrays = st9.samples_per_pixel * st9.num_pixels * 2 / dt9 / 1e6
    prof9 = _profile_step(lambda: step9(3), dt9 / 2 * 1e3)
    print(f"[9] fwd+bwd {st9.width}x{st9.height} {st9.samples_per_pixel} spp"
          f" {st9.max_bounces} bounces: launches (megakernel, sweep) "
          f"{fb_launches} in 3 steps; 2 steps in {dt9:.4f} s = "
          f"{fb_mrays:.3f} Mrays/s (fwd+bwd); {_profile_text(prof9)}; peak "
          f"memory {peak9 / 2**30:.3f} GiB | {card}", flush=True)
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
    adjoint_variants = {
        f"{base}{env}{bvh}{route}" for base, env in (
            ("B2", ""), ("B2", "c"), ("B2", "c+n"), ("B2b", ""),
            ("B2b", "+c"), ("B2b", "+c+n"))
        for bvh in ("", "+d") for route in ("", " global")}
    light_variants = {f"B1{v}e{t}" for v in ("", "b+", "c+", "b+c+")
                      for t in ("", "+d")}
    record_variants = {f"B1{v}d record" for v in ("", "b+", "c+", "b+c+")}
    record_variants |= {"B1a record", "B1b record", "B1c record",
                        "B1b+c record"}
    probe_variants = {"B1e+d probe", "B1b+e+d probe", "B1e probe",
                      "B1b+e probe"}
    sweep_variants = {f"{base}{env} sweep" for base, env in (
        ("B2", ""), ("B2", "c"), ("B2", "c+n"), ("B2b", ""), ("B2b", "+c"),
        ("B2b", "+c+n"))}
    # the light-NEE adjoint (B2+l): B1e's recording variants on both tiers
    # and the light sweeps
    light_record_variants = {f"{v} record" for v in light_variants}
    light_sweep_variants = {k.replace(" sweep", "+l sweep")
                            for k in sweep_variants}
    assert set(res) == {"B1a", "B1b", "B1c", "B1b+c", "B1d", "B1b+d",
                        "B1c+d", "B1b+c+d", *light_variants, "B3",
                        "sky forward",
                        "sky backward", "sky ordering count",
                        "sky ordering scan", "sky ordering scatter",
                        "sky backward sums",
                        *adjoint_variants, *record_variants,
                        *sweep_variants, *probe_variants,
                        *light_record_variants, *light_sweep_variants}, res
    expected = {**RESOURCES_BEFORE_B1E, **RESOURCES_SINCE_SHARED_SWEEP,
                **RESOURCES_SINCE_DIVISION}
    changed = {k: (v, res[k]) for k, v in expected.items()
               if tuple(res[k]) != v}
    print(f"[13] the {len(expected)} variants built before B1e keep their "
          f"registers and spills (the replay's "
          f"{sorted(RESOURCES_SINCE_SHARED_SWEEP)} as since the shared "
          f"sweep, {sorted(RESOURCES_SINCE_DIVISION)} as since the bounce "
          f"divides): {not changed} {changed}", flush=True)
    assert not changed, changed
    spilled = {k: res[k] for k in sweep_variants if res[k][1]}
    print(f"[13] the record route's kernels, both tiers: forward "
          f"{ {k: res[k] for k in sorted(record_variants)} }, sweep "
          f"{ {k: res[k] for k in sorted(sweep_variants)} } (registers, "
          f"spill-store bytes); sweeps that spill: {spilled}", flush=True)
    assert not spilled, spilled
    print(f"[13] B1e+d's light variants (an any-hit light shadow walk; "
          f"with the closest-hit walk it replaced: 104, 110, 108, 114 "
          f"registers, no spills) "
          f"{ {k: res[k] for k in sorted(light_variants) if '+d' in k} }; "
          f"the probes (both walks or scans, counted) "
          f"{ {k: res[k] for k in sorted(probe_variants)} }", flush=True)
    print(f"[13] B1e's brute-tier light variants (the culled shadow scan; "
          f"before: 94, 95, 95, 96 registers, no spills): "
          f"{ {k: res[k] for k in sorted(light_variants) if '+d' not in k} }"
          f" (registers, spill-store bytes); their dynamic shared memory is "
          f"the scene's tables, as the variants without light NEE take",
          flush=True)
    light_spill = {k: res[k] for k in light_variants if res[k][1]}
    assert not light_spill, light_spill
    spilled_l = {k: res[k] for k in light_sweep_variants if res[k][1]}
    print(f"[13] the light-NEE adjoint (B2+l): B1e's recording variants "
          f"{ {k: res[k] for k in sorted(light_record_variants)} } (beside "
          f"them without the record "
          f"{ {k: res[k] for k in sorted(light_variants)} }), the light "
          f"sweeps { {k: res[k] for k in sorted(light_sweep_variants)} } "
          f"(registers, spill-store bytes); light sweeps that spill: "
          f"{spilled_l}", flush=True)
    assert not spilled_l, spilled_l
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
        mk.LAUNCHES = adj.LAUNCHES = skyk.FORWARD_LAUNCHES = 0
        ht.render_frame(sc, cm, st14, 0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames14 = [ht.render_frame(sc, cm, st14, f + 1)
                    for f in range(n_frames)]
        torch.cuda.synchronize()
        dt14 = time.perf_counter() - t0
        launches14 = mk.LAUNCHES
        sky14 = skyk.FORWARD_LAUNCHES
        assert launches14 > 0, f"the {name} path did not launch the kernel"
        assert adj.LAUNCHES == 0
        # the sky pass is the sky kernel, one launch a group
        assert sky14 == (launches14 if skyk.uses_sky(sc, st14) else 0), sky14
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
        prof14 = _profile_step(
            lambda: ht.render_frame(sc, cm, st14, n_frames + 1),
            dt14 / n_frames * 1e3)
        if name == "glass":
            assert prof14["cuda_launches"] <= 3350, prof14
        main14[name] = (launches14, mr14, dt14 / n_frames, rel14, prof14,
                        sky14)
        print(f"[14] {name} {st14.width}x{st14.height} "
              f"{st14.samples_per_pixel} spp {st14.max_bounces} bounces: "
              f"{launches14} kernel launches and {sky14} sky kernel "
              f"launches in "
              f"{n_frames + 1} frames; {n_frames} frames in {dt14:.4f} s = "
              f"{mr14:.3f} Mrays/s; {_profile_text(prof14)}; 256x256 mean "
              f"radiance kernel vs plain rel {rel14:.2e} (< 2e-2) | {card}",
              flush=True)
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
    step15 = lambda f: render_loss_grad(params15, glass, cam, st15, zeros15,
                                        f)
    dt15, fb15, steps15, peak15, rep15 = brute_steps("15", step15, 64)
    dt15 *= 2  # two steps
    fb15_mrays = st15.samples_per_pixel * st15.num_pixels * 2 / dt15 / 1e6
    prof15 = _profile_step(lambda: step15(3), dt15 / 2 * 1e3)
    print(f"[15] glass fwd+bwd {st15.width}x{st15.height} "
          f"{st15.samples_per_pixel} spp {st15.max_bounces} bounces: "
          f"launches (megakernel, sweep) {fb15} in 3 steps; 2 steps in "
          f"{dt15:.4f} s = {fb15_mrays:.3f} Mrays/s (fwd+bwd); "
          f"{_profile_text(prof15)}; peak memory {peak15 / 2**30:.3f} GiB | "
          f"{card}", flush=True)
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
    # the envmap backward through render_loss_grad vs Fused.OFF, without
    # and with env NEE: materials and every mip. Each route's target is its
    # own image + c, so both get the same per-pixel cotangent (-2c/N); c
    # is 0 on the pixels whose forwards the two routes round apart (at
    # most 0.1%), so the backward is held where the paths agree
    cases15 = {
        "Cornell glossy under the sky": (sky_cornell, cam, ht.RenderSettings(
            width=64, height=64, samples_per_pixel=16, max_bounces=4,
            use_envmap=True)),
        "the spheres under the sky, env NEE": (
            spheres, sky_cam, ht.RenderSettings(
                width=64, height=64, samples_per_pixel=16, max_bounces=4,
                use_envmap=True, env_importance_sampling=True,
                env_mip_level=0)),
    }
    sky_counts = lambda: (mk.LAUNCHES, adj.SWEEP_LAUNCHES,
                          skyk.FORWARD_LAUNCHES, skyk.BACKWARD_LAUNCHES,
                          skyk.ORDER_LAUNCHES, skyk.SCATTER_LAUNCHES)
    gen15 = torch.Generator().manual_seed(15)
    for name, (sc, cm, st_sky) in cases15.items():
        p_sky = {"materials": sc.materials, "env_mips": sc.env_mips}
        st_off = st_sky.replace(fused=ht.Fused.OFF)
        img_k = ht.render_frame(sc, cm, st_sky, 1)
        img_p = ht.render_frame(sc, cm, st_off, 1)
        agree = ((img_k - img_p).abs() <= PARITY_TOL + PARITY_TOL
                 * img_p.abs()).all(dim=2, keepdim=True)
        n_apart = int((~agree).sum())
        assert n_apart <= PARITY_MAX_OUTSIDE * agree.numel(), name
        c15 = torch.rand(tuple(img_k.shape), generator=gen15).to(dev) * agree
        before = sky_counts()
        _, g_k = render_loss_grad(p_sky, sc, cm, st_sky, img_k + c15, 1)
        launched = tuple(a - b for a, b in zip(sky_counts(), before))
        _, g_p = render_loss_grad(p_sky, sc, cm, st_off, img_p + c15, 1)
        sky15 = {}
        for f in ("albedo", "specular", "roughness", "emissive",
                  "absorption"):
            sky15[f], ratio = _grad_compare(getattr(g_k["materials"], f),
                                            getattr(g_p["materials"], f))
            assert ratio <= 1.0, f"{name}: render_loss_grad {f} disagrees"
        env15 = [(float((a - b).abs().max()), float(b.abs().max()))
                 for a, b in zip(g_k["env_mips"], g_p["env_mips"])]
        assert all(bool(torch.isfinite(m).all()) for m in g_k["env_mips"])
        assert all(err <= 1e-4 * top + 1e-6 for err, top in env15), (
            f"{name}: a mip's gradient disagrees")
        assert min(launched) > 0, launched
        print(f"[15] envmap backward, {name} (64x64 16 spp, 4 bounces; "
              f"{n_apart} pixels whose forwards round apart, held out): "
              f"launches (megakernel, sweep, sky forward, sky backward, "
              f"sky ordering, sky sums) {launched}; vs Fused.OFF max |diff| "
              f"per field {sky15}; per mip (max |diff|, max |plain|) "
              f"{env15} (each <= 1e-4 max |plain| + 1e-6)", flush=True)

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

    def profiled_ms(fn, key, reps=10, per_call=False):
        """Mean device time of the kernel `key` (its name, with "<" for a
        template) over the launches the profiler recorded (with
        `per_call`, of all kernels whose names contain `key`, over the
        calls of fn, which must all have been recorded). Late in a long
        process the profiler can drop events, at times all of a session's:
        the mean is over what it kept, a session that kept none is
        repeated after a pause, and if five kept none the answer is None
        (printed "not recorded"): a fault of the tracing, not of the
        kernel, whose event times beside it do not pass through the
        profiler."""
        acts = [torch.profiler.ProfilerActivity.CUDA]
        name = key.rstrip("<")
        # the demangled name, or the mangled one where demangling failed
        keys = (key, f"{len(name)}{name}I" if key.endswith("<") else key)
        for attempt in range(5):
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(0.1 * attempt)
            kept = prof.key_averages()
            rows = [r for r in kept if any(k in r.key for k in keys)]
            count = sum(r.count for r in rows)
            if per_call and count:
                rows = [r for r in kept if _self_device_us(r) > 0
                        and key in r.key]
                return sum(_self_device_us(r) for r in rows) / 1e3 / reps
            if count:
                return sum(_self_device_us(r) for r in rows) / 1e3 / count
            print(f"    the profiler kept no {key} launch of {reps} "
                  f"(session {attempt + 1} of 5); it kept "
                  f"{[r.key[:60] for r in kept][:4]}", flush=True)
        return None

    def ms4(x):
        return "not recorded" if x is None else f"{x:.4f}"

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
              f"{ms4(times19[name][1])} ms (device); {work19[name][0]} "
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
        dev_ms = profiled_ms(kernel, "megakernel_bvh<", reps=5)
        p_ms = [_cuda_ms(plain, 1), _cuda_ms(plain, 1)]
        w = _path_work(sc, o_cam, d_cam, dcam.far, sidx_cam, seed_cam, st19)
        ops = _path_ops(w, sc.any_transmissive, "c" in name)
        nbytes = (o_cam.shape[0] * (32 + 4 * got.shape[1])
                  + _table_bytes((*tab19, sc.wbvh.nodes, et19)))
        b1d[name] = dict(ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, work=w,
                         bound=_bound(nbytes, ops), res=res[name])
        print(f"[19] {name}: one launch of {o_cam.shape[0]} rays, "
              f"{st19.max_bounces} bounces: {k_ms} ms (events), {ms4(dev_ms)}"
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
    prof20 = _profile_step(lambda: ht.render_frame(dragon, dcam, st_d, 3),
                           dt20 / 2 * 1e3)
    idle20 = prof20["idle_share"]
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
          f"{dt20:.4f} s = {mrays20:.3f} Mrays/s; {_profile_text(prof20)}; "
          f"256x256 Fused.OFF "
          f"frame ({b3_launches} launches of the traversal kernel) mean "
          f"radiance vs the kernel route rel {rel20:.2e} (< 2e-2) | {card}",
          flush=True)
    assert rel20 < 2e-2, "glass dragon mean radiance disagrees with plain"

    # --- 21. the adjoint's transcript routes
    pix64 = torch.arange(64 * 64, device=dev)
    st21 = glass_cases["glass_sobol_no_rr"].replace(
        max_bounces=20, max_transmission_bounces=20)
    assert adj.transcript_route(glass, st21) == "global", "cap"
    o21, d21, sidx21, seed21 = rays(pix64, 4, 4, st21, 1)
    ct21 = torch.rand((o21.shape[0], 3),
                      generator=torch.Generator().manual_seed(0)).to(dev)
    replay = torch.empty_like(o21)
    got = adj._launch(glass, o21, d21, cam.far, sidx21, seed21, ct21, st21,
                      None, replay)
    again = adj.trace_grad_fused_materials(glass, o21, d21, cam.far, sidx21,
                                           seed21, ct21, st21)
    fwd = mk.trace_color_fused(glass, o21, d21, cam.far, sidx21, seed21,
                               st21)
    ref = adj.trace_grad_fused_materials_reference(
        glass, o21, d21, cam.far, sidx21, seed21, ct21, st21)
    torch.cuda.synchronize()
    g21_err, ratio = _grad_compare(got, ref)
    repeat, replay_ok = torch.equal(got, again), torch.equal(replay, fwd)
    print(f"[21] glass adjoint, 20 bounces, no RR ({o21.shape[0]} rays): the "
          f"global route ({adj.smem_bytes(glass, st21)} bytes of shared "
          f"memory a block would need, budget {adj.SMEM_BUDGET}); [K, 12] max"
          f" |diff| {g21_err:.3e}, worst diff/bound {ratio:.3e} (<= 1); "
          f"bitwise repeatable {repeat}; replay color == forward "
          f"{replay_ok}", flush=True)
    assert ratio <= 1.0 and repeat and replay_ok, "global route"
    routes21 = {}
    for name, sc, st_r in (("B2", scene, cases["bounce_limits"]),
                           ("B2b", glass, glass_cases["glass_sobol_rr"])):
        o_r, d_r, sidx_r, seed_r = rays(pix64, 4, 4, st_r, 1)
        ct_r = torch.rand((o_r.shape[0], 3),
                          generator=torch.Generator().manual_seed(0)).to(dev)
        a, b = (adj._launch(sc, o_r, d_r, cam.far, sidx_r, seed_r, ct_r, st_r,
                            None, route=r) for r in ("shared", "global"))
        torch.cuda.synchronize()
        routes21[name] = dict(smem_bytes=adj.smem_bytes(sc, st_r),
                              same_bits=torch.equal(a, b))
        print(f"[21] {name}, {st_r.max_bounces} bounces: shared route "
              f"({routes21[name]['smem_bytes']} bytes a block) and global "
              f"route give the same bits: {routes21[name]['same_bits']}",
              flush=True)
        assert routes21[name]["same_bits"], f"{name} routes differ"

    # --- 22. B3 and B1d on a walk 19 entries deep
    strip = meshes.deep_strip_scene().build(envmap=sky, max_leaf=1,
                                            device=dev)
    scam = ht.make_camera(**meshes.STRIP_CAM, device=dev)
    st22 = ht.RenderSettings(width=64, height=64, samples_per_pixel=4,
                             max_bounces=4, use_envmap=True,
                             env_importance_sampling=True, env_mip_level=0)
    o22, d22, sidx22, seed22 = rays(pix64, 4, 4, st22, 1, scam)
    inf22 = torch.full((o22.shape[0],), float("inf"), device=dev)
    got = [x.cpu().numpy() for x in traverse.traverse_world(
        strip.wbvh, o22, d22, inf22)]
    ref = [x.cpu().numpy() for x in traverse.traverse_world_reference(
        strip.wbvh, o22, d22, inf22)]
    assert np.array_equal(np.isinf(got[0]), np.isinf(ref[0])), "strip hits"
    hit = np.isfinite(ref[0])
    hit_x = (o22[:, 0].cpu().numpy() + np.where(hit, ref[0], 0.0)
             * d22[:, 0].cpu().numpy())
    deep_hits = int((hit & (np.abs(hit_x - 1.15) < 1e-3)).sum())
    strip_err = max(float(np.abs(got[i][hit] - ref[i][hit]).max())
                    for i in (0, 2, 3))
    assert strip_err <= PARITY_TOL / 10 and np.array_equal(got[1], ref[1])
    assert deep_hits > 0, "no ray found triangle 1 in the 19th entry"
    got = mk.trace_fused_outputs(strip, o22, d22, scam.far, sidx22, seed22,
                                 st22)
    ref = mk.trace_color_fused_reference(strip, o22, d22, scam.far, sidx22,
                                         seed22, st22)
    col = mk.trace_color_fused(strip, o22, d22, scam.far, sidx22, seed22,
                               st22)
    torch.cuda.synchronize()
    n_bad, n_dir, bad_w, err22, n_sky, _, _ = compare_as_read(strip, got, ref)
    n_col, err_col = compare(col, deferred_sky(strip, st22, ref))
    n22 = got.shape[0]
    print(f"[22] the deep strip ({strip.num_triangles} triangles, max_leaf "
          f"1): B3 on {n22} camera rays, {int(hit.sum())} hits, "
          f"{deep_hits} on triangle 1 (found in the 19th stack entry), t/u/v"
          f" max |diff| {strip_err:.3e}, triangles equal; B1c+d outputs (but"
          f" 7-10) max |diff| {err22:.3e}, {n_bad} rays outside; on the "
          f"{n_sky} sky rays direction {n_dir}, MIS weight {bad_w} outside;"
          f" color after the sky max |diff| {err_col:.3e}, {n_col} rays "
          f"outside", flush=True)
    assert max(n_bad, n_dir, bad_w, n_col) <= PARITY_MAX_OUTSIDE * n22, (
        "deep strip B1d")

    # --- 23. each adjoint beside its forward kernel on the same rays, in
    # turns: forward, adjoint, adjoint, forward
    turns23 = {}
    for f_name, a_name, sc, st23, r23 in (
            ("B1a", "B2", scene, st_a, (o, d, sidx, seed)),
            ("B1b", "B2b", glass, st_g, (o_g, d_g, sidx_g, seed_g))):
        o23, d23, s23, e23 = r23
        tab23 = mk._scene_tables(sc)
        ct23 = torch.rand((o23.shape[0], 3),
                          generator=torch.Generator().manual_seed(0)).to(dev)
        fns = {f_name: (lambda: mk.trace_fused_outputs(
                   sc, o23, d23, cam.far, s23, e23, st23, tab23),
                        "megakernel<"),
               a_name: (lambda: adj.trace_grad_fused_materials(
                   sc, o23, d23, cam.far, s23, e23, ct23, st23, tab23),
                        "adjoint_kernel<")}
        t23 = {f_name: [], a_name: []}
        for name in (f_name, a_name, a_name, f_name):
            fn, key = fns[name]
            fn()
            t23[name].append((_cuda_ms(fn, 10), profiled_ms(fn, key)))
        dev_f, dev_a = ([x[1] for x in t23[k] if x[1] is not None]
                        for k in (f_name, a_name))
        dev_f = float(np.mean(dev_f)) if dev_f else None
        dev_a = float(np.mean(dev_a)) if dev_a else None
        own = None if None in (dev_f, dev_a) else dev_a - dev_f
        turns23[a_name] = dict(events_ms=[x[0] for x in t23[a_name]],
                               device_ms=[x[1] for x in t23[a_name]],
                               forward_device_ms=[x[1] for x in t23[f_name]],
                               own_device_ms=own)
        print(f"[23] {f_name} then {a_name} on the same {o23.shape[0]} rays, "
              f"{st23.max_bounces} bounces, in turns: {f_name} {t23[f_name]}"
              f" ms, {a_name} {t23[a_name]} ms (events, device); the "
              f"adjoint's own device time {ms4(own)} ms of "
              f"{ms4(dev_a)} | {card}", flush=True)

    # --- 25. the kernel's own rays, and the launch from pixels against the
    # explicit-ray launch
    from halogen_tpu_torch.integrator.trace import group_rays

    lens_cam = ht.make_camera(**CAM, aperture_deg=2.0, focal_distance=3.2,
                              device=dev)
    cases25 = {
        "B1a": (scene, cam, cases["sobol_rr"]),
        "B1b, thin lens": (glass, lens_cam, glass_cases["glass_sobol_rr"]),
        "B1c": (spheres, sky_cam, sky_cases["sky_spheres_nee"][2]),
        "B1b prng": (glass, cam, glass_cases["glass_prng_rr"]),
        "B1b+c+d": (dragon_sky, dcam, cases17["dragon_sky_nee"][1]),
    }
    rays25 = {}
    for name, (sc, cm, st25) in cases25.items():
        frame, lane0, spp_block = 3, 2, 2
        view = mk.pixel_view(cm, st25, frame, pix64)
        out, o25, d25, sidx25, seed25 = mk.trace_pixels_outputs(
            sc, view, lane0, spp_block, st25, write_rays=True)
        quiet = mk.trace_pixels_outputs(sc, view, lane0, spp_block, st25)
        explicit = mk.trace_fused_outputs(sc, o25, d25, cm.far, sidx25,
                                          seed25, st25)
        ro, rd, rsidx, rseed = group_rays(cm, st25, frame, pix64, lane0,
                                          spp_block)
        torch.cuda.synchronize()
        ints_ok = (torch.equal(sidx25, mk._as_i32(rsidx))
                   and torch.equal(seed25, mk._as_i32(rseed)))
        o_err = float((o25 - ro).abs().max())
        d_err = float((d25 - rd).abs().max())
        n_apart = int(((o25 != ro) | (d25 != rd)).any(dim=1).sum())
        same = torch.equal(out, explicit) and torch.equal(out, quiet)
        rays25[name] = dict(origin_max_abs_err=o_err,
                            direction_max_abs_err=d_err,
                            rays_not_bit_equal=n_apart)
        print(f"[25] {name}: {out.shape[0]} rays made in the kernel vs "
              f"group_rays on the card: sample index and seed bit for bit "
              f"{ints_ok}; origin max |diff| {o_err:.3e}, direction "
              f"{d_err:.3e} (<= 1e-6), {n_apart} rays not bit for bit; "
              f"launch from pixels == explicit-ray launch on those rays, "
              f"bit for bit: {same}", flush=True)
        assert ints_ok, f"{name}: sample index or seed differs"
        assert o_err <= 1e-6 and d_err <= 1e-6, f"{name}: rays differ"
        assert same, f"{name}: the launch from pixels took another path"

    # --- 26. warps that refill against one ray a thread, bit for bit
    # the threads of the smallest grid a refilling launch may have: one
    # block an SM
    grid_rays = 128 * torch.cuda.get_device_properties(
        0).multi_processor_count
    refill26 = {}
    for name, (sc, cm, st26, r26, et) in {
            "B1a": (scene, cam, st_a, (o, d, sidx, seed), None),
            "B1b": (glass, cam, st_g, (o_g, d_g, sidx_g, seed_g), None),
            "B1c": (spheres, sky_cam, st_e, (o_e, d_e, sidx_e, seed_e),
                    env_tab)}.items():
        for count in (100003, 1000):  # ragged; smaller than the grid
            assert count % 128 and (count == 1000) == (count < grid_rays)
            o26, d26, s26, e26 = (x[:count].contiguous() for x in r26)
            a = mk.trace_fused_outputs(sc, o26, d26, cm.far, s26, e26, st26,
                                       None, et)
            b = mk._launch(sc, o26, d26, cm.far, s26, e26, st26, None, et,
                           refill=False)
            torch.cuda.synchronize()
            refill26[(name, count)] = torch.equal(a, b)
            print(f"[26] {name}, {count} rays: the refilling launch == one "
                  f"ray a thread, bit for bit: {refill26[(name, count)]}",
                  flush=True)
            assert refill26[(name, count)], (name, count)

    # --- 27. the redesigned variants at the launch shape, from pixels (as
    # the main path launches them: 262144 rays, over the persistent grid,
    # so most rays are made by lanes that fell free) against the plain
    # version, `group_rays` then the lockstep integrator, and against the
    # explicit-ray launch; then their times
    def pixel_launch_check(name, sc, cm, st27, pix27, tab27, et, plain_rays):
        """One launch from pixels at the launch shape: its rays against
        `group_rays`, its outputs bit for bit against the explicit-ray
        launch on the rays it wrote, and against the plain version (on
        every `len / plain_rays`-th ray, spread over the launch). Returns
        (max |diff| vs plain, rays not bit-equal to group_rays, plain ms)."""
        view = mk.pixel_view(cm, st27, 1, pix27)
        out, o27, d27, s27, e27 = mk.trace_pixels_outputs(
            sc, view, 0, 1, st27, tab27, et, write_rays=True)
        explicit = mk.trace_fused_outputs(sc, o27, d27, cm.far, s27, e27,
                                          st27, tab27, et)
        n27 = out.shape[0]
        pick = torch.arange(0, n27, n27 // plain_rays, device=dev)

        def plain():
            r = group_rays(cm, st27, 1, pix27[pick], 0, 1)
            return mk.trace_color_fused_reference(sc, r[0], r[1], cm.far,
                                                  r[2], r[3], st27)
        ro, rd, rsidx, rseed = group_rays(cm, st27, 1, pix27, 0, 1)
        ref = plain()
        torch.cuda.synchronize()
        assert (torch.equal(s27, mk._as_i32(rsidx))
                and torch.equal(e27, mk._as_i32(rseed))), (
            f"{name}: sample index or seed differs at the launch shape")
        o_err = float((o27 - ro).abs().max())
        d_err = float((d27 - rd).abs().max())
        n_apart = int(((o27 != ro) | (d27 != rd)).any(dim=1).sum())
        assert o_err <= 1e-6 and d_err <= 1e-6, f"{name}: rays differ"
        assert torch.equal(out, explicit), (
            f"{name}: the launch from pixels took another path")
        if mk.uses_bvh(sc):
            n_bad, n_dir, bad_w, err, _, _, _ = compare_as_read(
                sc, out[pick], ref)
            n_bad = max(n_bad, n_dir, bad_w)
        else:
            n_bad, err = compare(out[pick, :10], ref[:, :10])
        p_ms = [_cuda_ms(plain, 1), _cuda_ms(plain, 1)]
        print(f"[27] {name}: a launch from pixels of {n27} rays, "
              f"{st27.max_bounces} bounces: rays vs group_rays sample index "
              f"and seed bit for bit, origin max |diff| {o_err:.3e}, "
              f"direction {d_err:.3e} (<= 1e-6), {n_apart} rays not bit for "
              f"bit; outputs == the explicit-ray launch bit for bit; vs "
              f"plain (group_rays and the lockstep) on {pick.shape[0]} of "
              f"them max |diff| {err:.3e}, {n_bad} rays outside "
              f"{PARITY_TOL}; plain {p_ms} ms", flush=True)
        assert n_bad <= PARITY_MAX_OUTSIDE * pick.shape[0], name
        return err, n_apart, p_ms

    times27, err27, plain27 = {}, {}, {}
    for name, (sc, cm, st27, pix27, r27, et) in {
            "B1a": (scene, cam, st_a, pix_g, (o, d, sidx, seed), None),
            "B1b": (glass, cam, st_g, pix_g, (o_g, d_g, sidx_g, seed_g),
                    None),
            "B1c": (spheres, sky_cam, st_e, pix_e,
                    (o_e, d_e, sidx_e, seed_e), env_tab)}.items():
        tab27 = mk._scene_tables(sc)
        err27[name], _, plain27[name] = pixel_launch_check(
            name, sc, cm, st27, pix27, tab27, et, pix27.shape[0])
        view = mk.pixel_view(cm, st27, 1, pix27)
        from_pixels = lambda: mk.trace_pixels_outputs(sc, view, 0, 1, st27,
                                                      tab27, et)
        o27, d27, s27, e27 = r27  # phase 13's: group_rays' on these pixels
        s27, e27 = mk._as_i32(s27), mk._as_i32(e27)
        from_rays = lambda: mk.trace_fused_outputs(sc, o27, d27, cm.far, s27,
                                                   e27, st27, tab27, et)
        threads = lambda: mk._launch(sc, o27, d27, cm.far, s27, e27, st27,
                                     tab27, et, refill=False)
        t27 = {}
        for key, fn in (("pixels", from_pixels), ("rays", from_rays),
                        ("rays, one a thread", threads)):
            fn()
            t27[key] = ([_cuda_ms(fn, 10), _cuda_ms(fn, 10)],
                        profiled_ms(fn, "megakernel<"))
        times27[name] = t27
        print(f"[27] {name}: one launch of {o27.shape[0]} rays, "
              f"{st27.max_bounces} bounces, ms (events x 2, device): "
              f"{t27}; registers, spill bytes {res[name]} | {card}",
              flush=True)
    # the BVH tier from pixels at the glass dragon's launch shape: B1b+d
    # (the glass dragon's frame; one ray a thread) and B1c+d (its warps
    # refill); plain, brute force over every triangle, on 16384 of the rays
    for name in ("B1b+d", "B1c+d"):
        sc, st27 = shapes19[name]
        tab27, et = mk._scene_tables(sc), mk.env_table(sc)
        err27[name], _, plain27[name] = pixel_launch_check(
            name, sc, dcam, st27, pix_g, tab27, et, 16384)
        view = mk.pixel_view(dcam, st27, 1, pix_g)
        from_pixels = lambda: mk.trace_pixels_outputs(sc, view, 0, 1, st27,
                                                      tab27, et)
        from_pixels()
        times27[name] = {"pixels": (
            [_cuda_ms(from_pixels, 5), _cuda_ms(from_pixels, 5)],
            profiled_ms(from_pixels, "megakernel_bvh<", reps=5))}
        print(f"[27] {name}: one launch from pixels of {pix_g.shape[0]} "
              f"rays, {st27.max_bounces} bounces, ms (events x 2, device): "
              f"{times27[name]['pixels']} | {card}", flush=True)

    # --- 28. the adjoint's BVH tier (B2+d, B2b+d) vs plain
    bounds_new = {}  # the new kernels' bounds, for phase 24's record
    from halogen_tpu_torch.scene.material import Material

    box = cornell.cornell_box(with_spheres=False)
    dverts, dfaces = meshes.dragon_mesh(3)
    box.add_mesh(dverts, dfaces, Material.metal((0.9, 0.6, 0.5),
                                                roughness=0.4),
                 transform=meshes._scale_translate(0.55, (0.0, -0.45, 0.0)))
    metal_dragon = box.build(device=dev)  # 1,280 triangles, opaque
    assert mk.uses_bvh(metal_dragon)
    ct_cam = torch.rand((o_cam.shape[0], 3),
                        generator=torch.Generator().manual_seed(0)).to(dev)
    # the plain version (brute force over every triangle) on every 16th
    # ray of the launch shape
    sub28 = [x[::16].contiguous() for x in (o_cam, d_cam, sidx_cam,
                                            seed_cam, ct_cam)]
    adj28 = {}
    for name, sc in (("B2b+d", dragon), ("B2+d", metal_dragon)):
        tab28 = mk._scene_tables(sc)
        o28, d28, s28, e28, c28 = sub28
        got = adj.trace_grad_fused_materials(sc, o28, d28, dcam.far, s28,
                                             e28, c28, st_d, tab28)
        again = adj.trace_grad_fused_materials(sc, o28, d28, dcam.far, s28,
                                               e28, c28, st_d, tab28)
        ref = adj.trace_grad_fused_materials_reference(
            sc, o28, d28, dcam.far, s28, e28, c28, st_d)
        replay = torch.empty_like(o28)
        adj._launch(sc, o28, d28, dcam.far, s28, e28, c28, st_d, tab28,
                    replay)
        fwd28 = mk.trace_fused_outputs(sc, o28, d28, dcam.far, s28, e28,
                                       st_d, tab28)
        routes28 = [adj._launch(sc, o28, d28, dcam.far, s28, e28, c28, st_d,
                                tab28, route=r) for r in ("shared",
                                                          "global")]
        torch.cuda.synchronize()
        err, ratio = _grad_compare(got, ref)
        repeat = torch.equal(got, again)
        replay_ok = torch.equal(replay, fwd28[:, 0:3])
        same_routes = torch.equal(routes28[0], routes28[1])
        kernel = lambda: adj.trace_grad_fused_materials(
            sc, o_cam, d_cam, dcam.far, sidx_cam, seed_cam, ct_cam, st_d,
            tab28)
        plain = lambda: adj.trace_grad_fused_materials_reference(
            sc, o28, d28, dcam.far, s28, e28, c28, st_d)
        kernel()
        k_ms = [_cuda_ms(kernel, 5), _cuda_ms(kernel, 5)]
        dev_ms = profiled_ms(kernel, "adjoint_kernel<", reps=5)
        p_ms = [_cuda_ms(plain, 1)]
        w = (b1d["B1b+d"]["work"] if sc is dragon else _path_work(
            sc, o_cam, d_cam, dcam.far, sidx_cam, seed_cam, st_d))
        nbytes = (o_cam.shape[0] * 44
                  + _table_bytes((*tab28, sc.wbvh.nodes))
                  + 12 * 4 * sc.materials.count)
        adj28[name] = dict(err=err, ms=k_ms, device_ms=dev_ms, plain_ms=p_ms,
                           bound=_bound(nbytes, _path_ops(
                               w, sc.any_transmissive, False, adjoint=True)),
                           smem_bytes=adj.smem_bytes(sc, st_d))
        print(f"[28] {name} ({sc.num_triangles} triangles, {st_d.max_bounces}"
              f" bounces): vs plain on {o28.shape[0]} rays [K, 12] max |diff|"
              f" {err:.3e}, worst diff/bound {ratio:.3e} (<= 1); bitwise "
              f"repeatable {repeat}; replay color == B1d's forward "
              f"{replay_ok}; shared ({adj28[name]['smem_bytes']} bytes a "
              f"block) and global routes the same bits {same_routes}; one "
              f"launch of {o_cam.shape[0]} rays {k_ms} ms (events), "
              f"{ms4(dev_ms)} ms (device); plain {p_ms} ms; bound "
              f"{adj28[name]['bound'][0]:.4f} ms by "
              f"{adj28[name]['bound'][1]} | {card}", flush=True)
        assert ratio <= 1.0 and repeat and replay_ok and same_routes, name

    # the record route at the same launch shape, for every BVH-tier
    # variant of the adjoint: the forward records the transcript (its
    # outputs equal those without the record), the sweep alone reads it
    # (equal to the replay bit for bit, [K, 12|13] and env-NEE records),
    # each half against its plain version, and their times
    sky12 = dict(use_envmap=True, env_mip_level=0)
    cases28r = {
        "B2+d": (metal_dragon, st_d),
        "B2b+d": (dragon, st_d),
        "B2c+d": (sky_hero, st_d.replace(**sky12)),
        "B2c+n+d": (sky_hero, st_d.replace(**sky12,
                                           env_importance_sampling=True)),
        "B2b+c+n+d": (dragon_sky, st_d.replace(
            **sky12, env_importance_sampling=True)),
    }
    def record_route(tag, name, sc, st28, cam28, ct28, fwd_v,
                     second_frame=None):
        """The record route of the adjoint variant `name` on the rays
        `cam28` (origin, direction, far, sample index, seed) with the
        color's cotangent `ct28`, printed under phase `tag`: the forward
        (variant `fwd_v`) with the record equal to it without, the sweep
        equal to the replay and repeatable, against `sweep_reference`, the
        record against the lockstep's on every 16th ray (and, in glass, on
        the rays `second_frame` of another frame), the route against the
        plain backward, and the times and bounds."""
        bvh = mk.uses_bvh(sc)
        n28 = cam28[0].shape[0]
        tab, et = mk._scene_tables(sc), mk.env_table(sc)
        env = adj.env_mode(sc, st28)
        nee = env == 2
        slots = st28.max_bounces + 1
        gsky28 = (torch.rand((n28, 4), generator=torch.Generator()
                             .manual_seed(3)).to(dev) if env else None)
        rec = mk.empty_record(n28, st28, nee, dev)
        fwd_rec = lambda: mk.trace_fused_outputs(sc, *cam28, st28, tab, et,
                                                 record=rec)
        fwd = lambda: mk.trace_fused_outputs(sc, *cam28, st28, tab, et)

        def nee_bufs():
            return ((torch.empty((n28, slots), dtype=torch.int32,
                                 device=dev),
                     torch.empty((n28, slots, 3), device=dev))
                    if nee else None)

        sweep = lambda recs=None: adj._launch(
            sc, None, None, None, None, None, ct28, st28, tab, gsky=gsky28,
            env_tab=et, records=recs, record=rec)
        replay = lambda recs=None: adj._launch(
            sc, *cam28, ct28, st28, tab, gsky=gsky28, env_tab=et,
            records=recs)
        out_rec, out = fwd_rec(), fwd()
        recs_s, recs_r = nee_bufs(), nee_bufs()
        got, again = sweep(recs_s), sweep()
        got_r = replay(recs_r)
        torch.cuda.synchronize()
        fwd_same = torch.equal(out_rec, out)
        routes_same = torch.equal(got, got_r) and torch.equal(got, again)
        if nee:
            lit = recs_s[0] >= 0
            routes_same = routes_same and torch.equal(
                recs_s[0], recs_r[0]) and torch.equal(recs_s[1][lit],
                                                      recs_r[1][lit])
        # the sweep against its plain version on the same record
        d_out = torch.cat([ct28, gsky28 if env else torch.zeros(
            (n28, 4), device=dev)], dim=1)
        sweep_plain = lambda: adj.sweep_reference(sc, st28, rec, d_out)
        ref_s, ref_recs = sweep_plain()
        bound_s = 1e-5 * ref_s.abs().amax(dim=0) + 1e-7
        sweep_ratio = float(((got - ref_s).abs() / bound_s).max())
        if nee:
            nee_ratio = float(((recs_s[1] - ref_recs[1]).abs()
                               / (1e-5 * ref_recs[1].abs().max() + 1e-7))
                              [lit].max())
            assert torch.equal(recs_s[0], ref_recs[0]), name
            sweep_ratio = max(sweep_ratio, nee_ratio)
        # the record against its plain version (the lockstep's transcript)
        # on every 16th ray, where the forward outputs agree at phase 11's
        # tolerance (all but the continuation pdf; through 12 bounces of
        # glass a ray's final direction can drift, phase 17, so up to 1% of
        # the rays may be held out); on those, ids and masks equal and the
        # floats at phase 11's tolerance (1e-4 + 1e-4 |plain|), in glass on
        # all but 0.1% of them (phase 11's allowance), where the drift that
        # phase 17 shows reaches a hit distance; in glass also on a second
        # frame's rays, and where the floats part, which and how
        sub = [x[::16].contiguous() if x.dim() else x for x in cam28]
        every16 = mk.Record(rec.a[:, ::16], rec.word[:, ::16],
                            rec.end[::16], *(None if t is None else
                                             t[:, ::16] for t in (
                                                 rec.nq, rec.ngw,
                                                 rec.texel)))
        cmp28 = [_record_vs_plain(sc, st28, sub, every16,
                                  out_rec[::16])]
        if sc.any_transmissive and second_frame is not None:
            sub2 = second_frame
            rec2 = mk.empty_record(sub2[0].shape[0], st28, nee, dev)
            out2 = mk.trace_fused_outputs(sc, *sub2, st28, tab, et,
                                          record=rec2)
            cmp28.append(_record_vs_plain(sc, st28, sub2, rec2, out2))
        agree = cmp28[0]["agree"]
        n_apart = int((~agree).sum())
        n_ids, n_floats = cmp28[0]["ids"], cmp28[0]["floats"]
        rec_err = max(c["err"] for c in cmp28)
        for c in cmp28:
            assert int((~c["agree"]).sum()) <= 0.01 * c["agree"].shape[0], (
                name, int((~c["agree"]).sum()))
        # floats apart past 1e-4: in glass (phase 17's drift) on at most
        # 0.1% of the rays; elsewhere none, but the env-NEE words (their
        # weight holds the glossy pdf, which phase 11 holds at rtol 1e-2
        # as output 10) on at most 0.1%
        rec_ok = all(
            c["ids"] == 0 and c["floats"] <= (
                PARITY_MAX_OUTSIDE * c["agree"].shape[0]
                if sc.any_transmissive or nee else 0)
            and (sc.any_transmissive or c["floats_past_nee"] == 0)
            for c in cmp28)
        if sc.any_transmissive or cmp28[0]["floats"]:
            for f, c in enumerate(cmp28, 1):
                print(f"[{tag}] {name}: the record vs the lockstep's, frame "
                      f"{f}: {c['agree'].shape[0]} rays, "
                      f"{int((~c['agree']).sum())} held out, ids or masks "
                      f"apart {c['ids']}, floats apart {c['floats']}: "
                      f"{c['drift']}", flush=True)
        # the record route against the plain backward (autograd through
        # the lockstep) at phase 7's tolerance, on the agreeing rays
        rec_sub = mk.empty_record(sub[0].shape[0], st28, nee, dev)
        mk.trace_fused_outputs(sc, *sub, st28, tab, et, record=rec_sub)
        d_sub = d_out[::16] * agree[:, None]
        got_sub = adj._launch(sc, None, None, None, None, None,
                              d_sub[:, 0:3].contiguous(), st28, tab,
                              gsky=d_sub[:, 3:7].contiguous() if env
                              else None, env_tab=et, record=rec_sub)
        ref_sub = adj.trace_grad_outputs_reference(sc, *sub, d_sub, st28)[0]
        plain_err, plain_ratio = _grad_compare(got_sub, ref_sub)
        print(f"[{tag}] {name} on the record route ({sc.num_triangles} "
              f"triangles, {st28.max_bounces} bounces, {n28} rays): the "
              f"forward's outputs with the record == without {fwd_same}; "
              f"the sweep == the replay bit for bit ([K, {got.shape[1]}]"
              f"{' and env-NEE records' if nee else ''}), repeatable "
              f"{routes_same}; vs sweep_reference "
              f"worst diff/bound {sweep_ratio:.3e} (<= 1); the record vs "
              f"the lockstep's on {agree.shape[0]} rays ({n_apart} apart, "
              f"held out): rays whose ids or masks differ {n_ids} (none), "
              f"whose floats differ past 1e-4 {n_floats} (none; in glass, "
              f"and in the env-NEE words, <= 0.1%) {rec_ok}"
              f", floats max |diff| / (1 + |plain|) {rec_err:.3e}; vs the "
              f"plain backward max |diff| "
              f"{plain_err:.3e}, worst diff/bound {plain_ratio:.3e} (<= 1)",
              flush=True)
        assert fwd_same and routes_same and rec_ok, name
        assert sweep_ratio <= 1.0, name
        assert plain_ratio <= 1.0, name
        # times: the forward without and with the record, the sweep, the
        # replay, the sweep's plain version
        tier = "megakernel_bvh" if bvh else "megakernel"
        t28 = {}
        for key, fn, prof_key in (
                ("forward", fwd, tier + "<"),
                ("forward with the record", fwd_rec, tier + "_record<"),
                ("sweep", sweep, "adjoint_sweep<"),
                ("replay", replay, "adjoint_kernel<")):
            fn()
            t28[key] = ([_cuda_ms(fn, 5), _cuda_ms(fn, 5)],
                        profiled_ms(fn, prof_key, reps=5))
        t28["sweep plain"] = ([_cuda_ms(sweep_plain, 1),
                               _cuda_ms(sweep_plain, 1)], None)
        # the sweep's bound: the bytes it must move (the words of the
        # shaded bounces, a ray's end word, its ct and sky cotangents, the
        # table and the [K, 12|13] partials and result) against its flops
        shaded = int(((rec.end.to(torch.int64) & 0xFFFF)).sum())
        words = adj.record_words(sc, st28)
        blocks = -(-n28 // adj.THREADS)
        cols = got.shape[1]
        kmat = sc.materials.count
        lit_count = int(lit.sum()) if nee else 0
        sweep_bytes = (shaded * 4 * words + n28 * (4 + 12 + (16 if env
                                                              else 0))
                       + 4 * kmat * 17 + 4 * (blocks + 1) * kmat * cols
                       + (n28 * slots * 4 + lit_count * 12 if nee else 0))
        sweep_ops = shaded * (OPS_SWEEP + (OPS_SWEEP_NEE if nee else 0))
        bound_sweep = _bound(sweep_bytes, sweep_ops)
        r = dict(
            err=plain_err, sweep_ratio=sweep_ratio, rec_err=rec_err,
            rec_rays_apart=[n_apart, n_ids, n_floats],
            times=t28, bound=bound_sweep, shaded=shaded,
            ops_ms=sweep_ops / PEAK_FLOPS * 1e3,
            record_bytes=adj.record_bytes(sc, st28, n28),
            record_written_bytes=shaded * 4 * words + 4 * n28,
            res=res[sweep_name(name)],
            smem_bytes=4 * kmat * (17 + adj.WARPS * cols),
            forward_variant=fwd_v, forward_res=res[fwd_v + " record"])
        print(f"[{tag}] {name}: ms (events x 2, device) {t28}; sweep "
              f"registers, spill bytes {r['res']}, dynamic shared "
              f"memory "
              f"{r['smem_bytes']} bytes a block; the recording "
              f"forward's ({fwd_v}) {r['forward_res']}; "
              f"{shaded} shaded bounces, record "
              f"{r['record_bytes'] / 1e6:.1f} MB a launch; sweep "
              f"bound {bound_sweep[0]:.4f} ms by {bound_sweep[1]} (its "
              f"flops alone {r['ops_ms']:.4f} ms) | {card}",
              flush=True)
        return r

    n28 = o_cam.shape[0]
    cam28 = (o_cam, d_cam, dcam.far, sidx_cam, seed_cam)
    o2, d2, s2, e2 = rays(pix_g[::16], 1, 32, st_d, 2, dcam)
    fwd28 = {"B2+d": "B1d", "B2b+d": "B1b+d", "B2c+d": "B1d",
             "B2c+n+d": "B1c+d", "B2b+c+n+d": "B1b+c+d"}
    rec28 = {name: record_route("28", name, sc, st28, cam28, ct_cam,
                                fwd28[name], [o2, d2, dcam.far, s2, e2])
             for name, (sc, st28) in cases28r.items()}

    # --- 29. the sky pair vs deferred_sky
    pix64 = torch.arange(64 * 64, device=dev)
    st29c = sky_cases["sky_cornell"][2]
    o29, d29, s29, e29 = rays(pix64, 4, 4, st29c, 1)
    tab_e = mk._scene_tables(spheres)
    cases29 = {
        "envmap_1024": (spheres, st_e, mk.trace_fused_outputs(
            spheres, o_e, d_e, sky_cam.far, sidx_e, seed_e, st_e, tab_e,
            env_tab)),
        "sky_cornell": (sky_cornell, st29c, mk.trace_fused_outputs(
            sky_cornell, o29, d29, cam.far, s29, e29, st29c)),
    }
    sky29 = {}
    for name, (sc, st29, out29) in cases29.items():
        n29 = out29.shape[0]
        ct29 = torch.rand((n29, 3),
                          generator=torch.Generator().manual_seed(0)).to(dev)
        col = skyk.sky_forward(sc, st29, out29)
        col_p = deferred_sky(sc, st29, out29)
        d4, env29 = skyk.sky_backward_full(sc, st29, out29, ct29)
        d4b, env29b = skyk.sky_backward_full(sc, st29, out29, ct29)
        d4p, env29p = skyk.sky_backward_reference(sc, st29, out29, ct29)
        torch.cuda.synchronize()
        n_bad, f_err = compare(col, col_p)
        bound4 = 1e-4 * d4p.abs().max(dim=0).values + 1e-6
        bad4 = int(((d4 - d4p).abs() > bound4).any(dim=1).sum())
        lv_err = [float((a - b).abs().max()) for a, b in zip(env29, env29p)]
        lv_ok = all(float((a - b).abs().max())
                    <= 1e-4 * float(b.abs().max()) + 1e-6
                    for a, b in zip(env29, env29p))
        repeat = torch.equal(d4, d4b) and all(
            torch.equal(a, b) for a, b in zip(env29, env29b))
        sky29[name] = dict(fwd_err=f_err, d4_err=float((d4 - d4p).abs()
                                                       .max()),
                           mip_err=lv_err)
        print(f"[29] {name}: {n29} rays; sky forward vs deferred_sky max "
              f"|diff| {f_err:.3e}, {n_bad} rays outside {PARITY_TOL}; "
              f"backward: miss attenuation and roughness cotangents max "
              f"|diff| {sky29[name]['d4_err']:.3e}, {bad4} rays outside "
              f"1e-4 of the column's largest; per mip max |diff| "
              f"{[f'{x:.2e}' for x in lv_err]} (<= 1e-4 max |mip| + 1e-6: "
              f"{lv_ok}); two calls bitwise equal {repeat}", flush=True)
        assert n_bad <= PARITY_MAX_OUTSIDE * n29, f"sky forward {name}"
        assert bad4 <= PARITY_MAX_OUTSIDE * n29, f"sky backward {name}"
        assert lv_ok and repeat, f"sky backward {name}"
    # times at the envmap_1024 launch shape
    out_e = cases29["envmap_1024"][2]
    n_e = out_e.shape[0]
    ct_e = torch.rand((n_e, 3),
                      generator=torch.Generator().manual_seed(0)).to(dev)
    fns29 = {
        "sky forward": (lambda: skyk.sky_forward(spheres, st_e, out_e),
                        lambda: deferred_sky(spheres, st_e, out_e),
                        "sky_forward"),
        "sky backward": (
            lambda: skyk.sky_backward_full(spheres, st_e, out_e, ct_e),
            lambda: skyk.sky_backward_reference(spheres, st_e, out_e, ct_e),
            "sky_"),
    }
    _, keys_e, wts_e = skyk.sky_backward(spheres, st_e, out_e, ct_e)
    n_tex = sum(int(m.shape[0] * m.shape[1]) for m in spheres.env_mips)
    # the backward's ordering and sums held at three sets of keys: the
    # launch shape's taps, the same rays' taps into a 512 x 1024 map (6
    # mips, 698,880 texels, 20 key bits), and the launch shape's env-NEE
    # records (B2c+n, into the finest mip's 8,192 texels)
    big_img = np.random.default_rng(7).uniform(
        0.0, 2.0, (512, 1024, 3)).astype(np.float32)
    big_mips = tuple(torch.from_numpy(np.ascontiguousarray(m)).to(dev)
                     for m in Envmap.from_equirect(big_img, 6).mips)
    n_big = sum(int(m.shape[0] * m.shape[1]) for m in big_mips)
    d4_e = skyk.sky_backward(spheres, st_e, out_e, ct_e)[0]
    slots = st_e.max_bounces + 1
    rec_e = (torch.empty((n_e, slots), dtype=torch.int32, device=dev),
             torch.empty((n_e, slots, 3), device=dev))
    adj._launch(spheres, o_e, d_e, sky_cam.far, sidx_e, seed_e, ct_e, st_e,
                tab_e, gsky=d4_e, env_tab=env_tab, records=rec_e)
    h_f, w_f = spheres.env_cdf.pdf.shape
    sets29 = {
        "envmap_1024 taps": (keys_e, wts_e, n_tex,
                             [m.shape[:2] for m in spheres.env_mips]),
        "512x1024 atlas taps": (*skyk.sky_backward(
            spheres, st_e, out_e, ct_e, big_mips)[1:], n_big,
            [m.shape[:2] for m in big_mips]),
        "envmap_1024 records": (rec_e[0].reshape(-1),
                                rec_e[1].reshape(-1, 3), h_f * w_f,
                                [(h_f, w_f)]),
    }
    scat29 = {}
    for name, (keys29, wts29, nt29, shapes29) in sets29.items():
        ordered, idx29 = skyk.order_texels(keys29, nt29)
        ref_k, ref_perm = torch.sort(keys29, stable=True)
        keep29 = ref_k >= 0
        order_ok = (torch.equal(ordered, ref_k[keep29])
                    and torch.equal(idx29.long(), ref_perm[keep29]))
        got29 = skyk.scatter_texels(keys29, wts29, nt29)
        again29 = skyk.scatter_texels(keys29, wts29, nt29)
        model29 = skyk.reduce_texels_model(ordered, wts29[idx29.long()],
                                           nt29)
        live = keys29 >= 0
        ref29 = torch.zeros((nt29, 3), dtype=torch.float64,
                            device=dev).index_add_(
            0, keys29[live].long(), wts29[live].double())
        mip_err, mip_ok, off = [], True, 0
        for h29, w29 in shapes29:
            g = got29[off:off + h29 * w29].double()
            r = ref29[off:off + h29 * w29]
            off += h29 * w29
            mip_err.append(float((g - r).abs().max()))
            mip_ok &= mip_err[-1] <= 1e-4 * float(r.abs().max()) + 1e-6
        repeat29 = torch.equal(got29, again29)
        model_ok = torch.equal(got29, model29)
        if name == "envmap_1024 taps":  # the main path's taps count the
            # ordering's first pass: the same bits
            full29 = skyk.sky_backward_full(spheres, st_e, out_e, ct_e)[1]
            repeat29 &= all(torch.equal(a, b) for a, b in zip(
                full29, skyk.split_mips(got29, spheres.env_mips)))
        kept29 = int(keep29.sum())
        keys_l, wts_l = keys29[live].long(), wts29[live]
        st29 = torch.cuda.current_stream().cuda_stream
        stages = {
            "ordering": (lambda k=keys29, t=nt29: skyk._order(k, t, st29),
                         "sky_radix_"),
            "sums": (lambda a=skyk._order(keys29, nt29, st29), w=wts29,
                     t=nt29: skyk._sums(*a, w, t, st29),
                     "sky_reduce_texels"),
            "ordering and sums": (lambda k=keys29, w=wts29, t=nt29:
                                  skyk.scatter_texels(k, w, t), "sky_r"),
        }
        times = {}
        for stage, (fn, key) in stages.items():
            fn()
            times[stage] = dict(ms=[_cuda_ms(fn, 10), _cuda_ms(fn, 10)],
                                device_ms=profiled_ms(fn, key,
                                                      per_call=True))
        lib_sort = lambda k=keys29: torch.sort(k, stable=True)
        lib_add = lambda k=keys_l, w=wts_l, t=nt29: torch.zeros(
            (t, 3), device=dev).index_add_(0, k, w)
        lib_sort(), lib_add()
        times["ordering"]["library_ms"] = _cuda_ms(lib_sort, 10)
        times["sums"]["library_ms"] = _cuda_ms(lib_add, 10)
        m29 = keys29.shape[0]
        times["ordering"]["bound"] = _bound(4 * m29 + 8 * kept29, 0)
        times["sums"]["bound"] = _bound(20 * kept29 + 12 * nt29, 0)
        scat29[name] = dict(taps=m29, kept=kept29, texels=nt29,
                            order_equal=order_ok, repeat=repeat29,
                            model_bits=model_ok, mip_err=mip_err,
                            stages=times)
        print(f"[29] {name}: {m29} keys, {kept29} in [0, {nt29}); the "
              f"order equals torch.sort(stable=True)'s {order_ok}; per "
              f"mip max |diff| vs index_add_ in float64 "
              f"{[f'{x:.2e}' for x in mip_err]} (<= 1e-4 max |mip| + "
              f"1e-6: {mip_ok}); two calls bitwise equal {repeat29}; "
              f"equal to reduce_texels_model {model_ok}; ordering "
              f"{times['ordering']['ms']} ms (events), "
              f"{ms4(times['ordering']['device_ms'])} (device), torch.sort "
              f"{times['ordering']['library_ms']:.4f}, bound "
              f"{times['ordering']['bound'][0]:.4f}; sums "
              f"{times['sums']['ms']} ms, "
              f"{ms4(times['sums']['device_ms'])} (device), index_add_ "
              f"{times['sums']['library_ms']:.4f}, bound "
              f"{times['sums']['bound'][0]:.4f}; both "
              f"{times['ordering and sums']['ms']} ms | {card}", flush=True)
        assert order_ok and mip_ok and repeat29 and model_ok, name
    keep_e = keys_e >= 0
    keys_l, wts_l = keys_e[keep_e].long(), wts_e[keep_e]
    library29 = lambda: torch.zeros((n_tex, 3), device=dev).index_add_(
        0, keys_l, wts_l)
    library29()
    lib29_ms = [_cuda_ms(library29, 10), _cuda_ms(library29, 10)]
    times29 = {}
    for name, (kernel, plain, key) in fns29.items():
        kernel()
        p_ms = [_cuda_ms(plain, 1)]
        k_ms = [_cuda_ms(kernel, 10), _cuda_ms(kernel, 10)]
        p_ms.append(_cuda_ms(plain, 1))
        times29[name] = (k_ms, profiled_ms(kernel, key), p_ms)
        print(f"[29] {name} at the envmap_1024 launch shape ({n_e} rays): "
              f"{k_ms} ms (events), {ms4(times29[name][1])} ms (device, a "
              f"kernel's launch), plain {p_ms} ms | {card}", flush=True)
    order29 = skyk._workspace(keys_e.shape[0], n_tex, dev)
    bwd_call_ms = profiled_ms(fns29["sky backward"][0], "sky_",
                              per_call=True)
    print(f"[29] sky backward, every kernel of a call: "
          f"{ms4(bwd_call_ms)} ms (device) | {card}", flush=True)
    taps29 = lambda: skyk.sky_backward(spheres, st_e, out_e, ct_e,
                                       order=order29)
    taps29()
    taps_ms = dict(ms=[_cuda_ms(taps29, 10), _cuda_ms(taps29, 10)],
                   device_ms=profiled_ms(taps29, "sky_backward_taps"))
    print(f"[29] sky backward's taps at the envmap_1024 launch shape (with "
          f"the ordering's first-pass counts, as on the main path): "
          f"{taps_ms['ms']} ms (events), {ms4(taps_ms['device_ms'])} ms "
          f"(device) | {card}", flush=True)
    print(f"[29] index_add_ of the backward's {int(keep_e.sum())} taps (a "
          f"library call with float atomics, used nowhere in the port): "
          f"{lib29_ms} ms | {card}", flush=True)
    atlas_bytes = 12 * n_tex
    bounds_new["sky forward"] = _bound(
        n_e * (4 * out_e.shape[1] + 12) + atlas_bytes, n_e * OPS_SKY)
    bounds_new["sky backward"] = _bound(
        n_e * (4 * out_e.shape[1] + 12 + 16) + 2 * atlas_bytes,
        n_e * (OPS_SKY + OPS_SKY_BWD))
    taps_ms["bound"] = _bound(
        n_e * (4 * out_e.shape[1] + 12 + 16 + 16 * skyk.TAPS) + atlas_bytes,
        n_e * (OPS_SKY + OPS_SKY_BWD))

    # --- 30. the adjoint's sky variants vs plain
    cases30 = {
        "B2c": (sky_cornell, cam, sky_cases["sky_cornell"][2]),
        "B2c+n": (spheres, sky_cam, sky_cases["sky_spheres_nee"][2]),
        "B2b+c+n": (glass_sky, cam, sky_cases["sky_glass_nee"][2]),
        "B2c+d": (sky_hero, dcam, cases17["hero_sky"][1]),
        "B2c+n+d": (sky_hero, dcam, cases17["hero_sky_nee"][1]),
        "B2b+c+n+d": (dragon_sky, dcam, cases17["dragon_sky_nee"][1]),
    }
    adj30 = {}
    for name, (sc, cm, st30) in cases30.items():
        o30, d30, s30, e30 = rays(pix64, 4, 4, st30, 1, cm)
        n30 = o30.shape[0]
        # the backward is held where the forward paths agree: a ray whose
        # color or whose miss attenuation and roughness (what the sky
        # backward reads) the kernel and plain round apart by more than
        # phase 11's tolerance (a near-mirror lobe's pdf turns an ulp of
        # direction into percents of an MIS weight; phase 17) gets a zero
        # cotangent; at most 0.1% of the rays may be so
        out_k = mk.trace_fused_outputs(sc, o30, d30, cm.far, s30, e30, st30)
        out_p = mk.trace_color_fused_reference(sc, o30, d30, cm.far, s30,
                                               e30, st30)
        pair = [torch.cat([deferred_sky(sc, st30, x), x[:, 3:7]], dim=1)
                for x in (out_k, out_p)]
        agree = ((pair[0] - pair[1]).abs()
                 <= PARITY_TOL + PARITY_TOL * pair[1].abs()).all(dim=1)
        n_apart = int((~agree).sum())
        assert n_apart <= PARITY_MAX_OUTSIDE * n30, f"{name} forward"
        ct30 = torch.rand((n30, 3), generator=torch.Generator().manual_seed(
            0)).to(dev) * agree[:, None]
        sweeps = adj.SWEEP_LAUNCHES
        got, env30 = adj.trace_grad_fused(sc, o30, d30, cm.far, s30, e30,
                                          ct30, st30)
        recorded = adj.SWEEP_LAUNCHES > sweeps
        assert recorded, name  # both tiers record
        same30 = True
        if recorded:  # the replay (RECORD_BUDGET 0) gives the same bits
            saved, adj.RECORD_BUDGET = adj.RECORD_BUDGET, 0
            try:
                rep30, env_rep = adj.trace_grad_fused(
                    sc, o30, d30, cm.far, s30, e30, ct30, st30)
            finally:
                adj.RECORD_BUDGET = saved
            same30 = torch.equal(got, rep30) and all(
                torch.equal(a, b) for a, b in zip(env30, env_rep))
        again, env30b = adj.trace_grad_fused(sc, o30, d30, cm.far, s30, e30,
                                             ct30, st30)
        ref, env30p = adj.trace_grad_fused_reference(sc, o30, d30, cm.far,
                                                     s30, e30, ct30, st30)
        replay = torch.empty_like(o30)
        adj._launch(sc, o30, d30, cm.far, s30, e30, ct30, st30, None,
                    replay, gsky=torch.zeros((o30.shape[0], 4), device=dev))
        fwd30 = mk.trace_fused_outputs(sc, o30, d30, cm.far, s30, e30, st30)
        torch.cuda.synchronize()
        err, ratio = _grad_compare(got, ref)
        lv_err = [float((a - b).abs().max()) for a, b in zip(env30, env30p)]
        lv_ok = all(float((a - b).abs().max())
                    <= 1e-4 * float(b.abs().max()) + 1e-6
                    for a, b in zip(env30, env30p))
        repeat = torch.equal(got, again) and all(
            torch.equal(a, b) for a, b in zip(env30, env30b))
        replay_ok = torch.equal(replay, fwd30[:, 0:3])
        adj30[name] = dict(err=err, mip_err=lv_err, rays_apart=n_apart)
        print(f"[30] {name}: {n30} rays ({n_apart} whose forward paths "
              f"round apart, held out), {st30.max_bounces} "
              f"bounces; [K, {got.shape[1]}] max |diff| {err:.3e}, worst "
              f"diff/bound {ratio:.3e} (<= 1); per mip max |diff| "
              f"{[f'{x:.2e}' for x in lv_err]} (<= 1e-4 max |mip| + 1e-6: "
              f"{lv_ok}); bitwise repeatable {repeat}; replay color == "
              f"forward {replay_ok}; record route {recorded}, equal to the "
              f"replay's bits {same30}", flush=True)
        assert ratio <= 1.0 and lv_ok and repeat and replay_ok, name
        assert same30, name
    # B2c and B2c+n at the envmap_1024 launch shape, with the sky
    # backward's cotangents (phase 29's d4_e, and its record buffers)
    times30 = {}
    for name, st30 in (("B2c", st_e.replace(env_importance_sampling=False)),
                       ("B2c+n", st_e)):
        nee30 = st30.env_importance_sampling
        out30 = (out_e if nee30 else mk.trace_fused_outputs(
            spheres, o_e, d_e, sky_cam.far, sidx_e, seed_e, st30, tab_e))
        d4_30 = (d4_e if nee30 else
                 skyk.sky_backward(spheres, st30, out30, ct_e)[0])
        kernel = lambda: adj._launch(
            spheres, o_e, d_e, sky_cam.far, sidx_e, seed_e, ct_e, st30,
            tab_e, gsky=d4_30, env_tab=env_tab if nee30 else None,
            records=rec_e if nee30 else None)
        plain = lambda: adj.trace_grad_outputs_reference(
            spheres, o_e, d_e, sky_cam.far, sidx_e, seed_e,
            torch.cat([ct_e, d4_30], dim=1), st30, want_env=nee30)
        got, ref = kernel(), plain()[0]
        torch.cuda.synchronize()
        err30, ratio30 = _grad_compare(got, ref)
        assert ratio30 <= 1.0, f"{name} at the launch shape"
        env30_text = ""
        if nee30:
            # the finest mip's sums of the records, on the rays whose
            # forward paths agree (as above)
            out_pe = mk.trace_color_fused_reference(
                spheres, o_e, d_e, sky_cam.far, sidx_e, seed_e, st30)
            pair = [torch.cat([deferred_sky(spheres, st30, x), x[:, 3:7]],
                              dim=1) for x in (out30, out_pe)]
            agree_e = ((pair[0] - pair[1]).abs() <= PARITY_TOL + PARITY_TOL
                       * pair[1].abs()).all(dim=1)
            apart_e = int((~agree_e).sum())
            assert apart_e <= PARITY_MAX_OUTSIDE * n_e, f"{name} forward"
            d_keep = torch.cat([ct_e, d4_30], dim=1) * agree_e[:, None]
            env_k = adj.trace_grad_outputs(
                spheres, o_e, d_e, sky_cam.far, sidx_e, seed_e, d_keep, st30,
                tab_e, env_tab, want_env=True)[1]
            env_p = adj.trace_grad_outputs_reference(
                spheres, o_e, d_e, sky_cam.far, sidx_e, seed_e, d_keep, st30,
                want_env=True)[1]
            env_err = float((env_k - env_p).abs().max())
            env_top = float(env_p.abs().max())
            assert env_err <= 1e-4 * env_top + 1e-6, f"{name} records"
            env30_text = (f"; the finest mip's record sums ({apart_e} rays "
                          f"apart, held out) max |diff| {env_err:.3e}, max "
                          f"|plain| {env_top:.3e} (<= 1e-4 max + 1e-6)")
        p_ms = [_cuda_ms(plain, 1)]
        k_ms = [_cuda_ms(kernel, 10), _cuda_ms(kernel, 10)]
        p_ms.append(_cuda_ms(plain, 1))
        dev30 = profiled_ms(kernel, "adjoint_kernel<")
        w30 = _path_work(spheres, o_e, d_e, sky_cam.far, sidx_e, seed_e,
                         st30)
        route30 = adj.transcript_route(spheres, st30)
        bounds_new[name] = _bound(
            n_e * (44 + 16 + (16 * slots if nee30 else 0))
            + _table_bytes((*tab_e, env_tab if nee30 else None))
            + 13 * 4 * spheres.materials.count,
            _path_ops(w30, False, nee30, adjoint=True))
        reg30 = res[name + (" global" if route30 == "global" else "")]
        times30[name] = dict(ms=k_ms, device_ms=dev30, plain_ms=p_ms,
                             err=err30, route=route30, res=reg30)
        print(f"[30] {name} at the envmap_1024 launch shape ({n_e} rays, "
              f"{st30.max_bounces} bounces, {route30} route): {k_ms} ms "
              f"(events), {ms4(dev30)} ms (device); plain {p_ms} ms; "
              f"[K, 13] max |diff| {err30:.3e}, worst diff/bound "
              f"{ratio30:.3e}{env30_text}; bound "
              f"{bounds_new[name][0]:.4f} ms by "
              f"{bounds_new[name][1]}; registers, spill bytes {reg30} | "
              f"{card}", flush=True)

    # --- 31. the full-width gradient steps and the envmap_1024 frame
    def timed_steps(fn, n_steps):
        """A warm-up and `n_steps` timed calls of fn(frame) with every
        kernel count set to 0 before the warm-up: (seconds per step,
        {kernel: launches in the n_steps + 1 calls}, the results)."""
        mk.LAUNCHES = adj.LAUNCHES = 0
        mk.RECORD_LAUNCHES = adj.SWEEP_LAUNCHES = 0
        skyk.FORWARD_LAUNCHES = skyk.BACKWARD_LAUNCHES = 0
        skyk.ORDER_LAUNCHES = skyk.SCATTER_LAUNCHES = 0
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fn(f + 1) for f in range(n_steps)]
        torch.cuda.synchronize()
        dt_ = (time.perf_counter() - t0) / n_steps
        counts = dict(megakernel=mk.LAUNCHES, adjoint=adj.LAUNCHES,
                      record=mk.RECORD_LAUNCHES, sweep=adj.SWEEP_LAUNCHES,
                      sky_forward=skyk.FORWARD_LAUNCHES,
                      sky_backward=skyk.BACKWARD_LAUNCHES,
                      sky_ordering=skyk.ORDER_LAUNCHES,
                      sky_sums=skyk.SCATTER_LAUNCHES)
        return dt_, counts, outs

    steps31 = {}
    zeros_d = torch.zeros((st_d.height, st_d.width, 3), device=dev)
    zeros_e = torch.zeros((st_e.height, st_e.width, 3), device=dev)
    st_m = st_d.replace(width=256, height=256)
    zeros_m = torch.zeros((256, 256, 3), device=dev)
    st_c = st9.replace(width=256, height=256, samples_per_pixel=16,
                       max_bounces=4, use_envmap=True)
    glass_step = lambda f: render_loss_grad(
        {"materials": dragon.materials}, dragon, dcam, st_d, zeros_d, f)
    metal_step = lambda f: render_loss_grad(
        {"materials": metal_dragon.materials}, metal_dragon, dcam, st_m,
        zeros_m, f)
    envmap_step = lambda f: render_loss_grad(
        {"materials": spheres.materials, "env_mips": spheres.env_mips},
        spheres, sky_cam, st_e, zeros_e, f)
    zeros_c = torch.zeros((256, 256, 3), device=dev)
    sky_cornell_step = lambda f: render_loss_grad(
        {"materials": sky_cornell.materials,
         "env_mips": sky_cornell.env_mips}, sky_cornell, cam, st_c,
        zeros_c, f)
    jobs31 = {
        # name: (step, settings, the kernels its path must launch, those
        # it must not); every step on the record route (the forward
        # records, the backward sweeps; both tiers), then again with
        # RECORD_BUDGET = 0 (the replay)
        "glass_dragon fwd+bwd": (glass_step, st_d,
                                 ("megakernel", "record", "sweep"),
                                 ("adjoint",)),
        "envmap_1024 fwd+bwd": (envmap_step, st_e, (
            "megakernel", "record", "sweep", "sky_forward", "sky_backward",
            "sky_ordering", "sky_sums"), ("adjoint",)),
        "metal_dragon fwd+bwd 256": (metal_step, st_m,
                                     ("megakernel", "record", "sweep"),
                                     ("adjoint",)),
        "sky_cornell fwd+bwd 256": (sky_cornell_step, st_c, (
            "megakernel", "record", "sweep", "sky_forward", "sky_backward",
            "sky_ordering", "sky_sums"), ("adjoint",)),
        "glass_dragon fwd+bwd replay": (glass_step, st_d,
                                        ("megakernel", "adjoint"),
                                        ("record", "sweep")),
        "metal_dragon fwd+bwd 256 replay": (metal_step, st_m,
                                            ("megakernel", "adjoint"),
                                            ("record", "sweep")),
        "envmap_1024 fwd+bwd replay": (envmap_step, st_e, (
            "megakernel", "adjoint", "sky_forward", "sky_backward",
            "sky_ordering", "sky_sums"), ("record", "sweep")),
        "sky_cornell fwd+bwd 256 replay": (sky_cornell_step, st_c, (
            "megakernel", "adjoint", "sky_forward", "sky_backward",
            "sky_ordering", "sky_sums"), ("record", "sweep")),
    }
    outs31 = {}
    for name, (fn, st31, need, shun) in jobs31.items():
        n_steps = 2
        saved_budget = adj.RECORD_BUDGET
        if name.endswith("replay"):
            adj.RECORD_BUDGET = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            dt31, counts, outs = timed_steps(fn, n_steps)
            torch.cuda.synchronize()
            peak31 = torch.cuda.max_memory_allocated()
            prof31 = _profile_step(lambda: fn(n_steps + 1), dt31 * 1e3)
        finally:
            adj.RECORD_BUDGET = saved_budget
        outs31[name] = outs
        for loss, grads in outs:
            assert bool(torch.isfinite(loss)), name
            for f in dataclasses.fields(grads["materials"]):
                g = getattr(grads["materials"], f.name)
                assert bool(torch.isfinite(g.float()).all()), (name, f.name)
            for m in grads.get("env_mips", ()):
                assert bool(torch.isfinite(m).all()), name
        missing = [k for k in need if counts[k] == 0]
        assert not missing, f"{name} launched none of {missing}"
        stray = [k for k in shun if counts[k] != 0]
        assert not stray, f"{name} launched {stray}"
        mr31 = st31.samples_per_pixel * st31.num_pixels / dt31 / 1e6
        steps31[name] = dict(step_ms=dt31 * 1e3, mrays_fwd_bwd=mr31,
                             launches=counts, profile=prof31,
                             peak_bytes=peak31)
        print(f"[31] {name} {st31.width}x{st31.height} "
              f"{st31.samples_per_pixel} spp {st31.max_bounces} bounces: "
              f"{counts} launches in {n_steps + 1} steps; step "
              f"{dt31 * 1e3:.1f} ms = {mr31:.3f} Mrays/s (fwd+bwd); "
              f"{_profile_text(prof31)}; peak memory "
              f"{peak31 / 2**30:.3f} GiB | {card}", flush=True)
    for name in ("glass_dragon fwd+bwd", "metal_dragon fwd+bwd 256",
                 "envmap_1024 fwd+bwd", "sky_cornell fwd+bwd 256"):
        same = all(
            torch.equal(a[0], b[0]) and all(
                torch.equal(getattr(a[1]["materials"], f.name),
                            getattr(b[1]["materials"], f.name))
                for f in dataclasses.fields(a[1]["materials"]))
            and all(torch.equal(x, y) for x, y in zip(
                a[1].get("env_mips", ()), b[1].get("env_mips", ())))
            and len(a[1].get("env_mips", ())) == len(b[1].get("env_mips",
                                                              ()))
            for a, b in zip(outs31[name], outs31[name + " replay"]))
        print(f"[31] {name}: the record route's losses, material "
              f"gradients and mips == the replay's bit for bit {same}",
              flush=True)
        assert same, name
    prof_e = main14["envmap_1024"][4]
    print(f"[31] envmap_1024 forward frame through the sky kernel (phase "
          f"14): {main14['envmap_1024'][2] * 1e3:.1f} ms a frame, "
          f"{main14['envmap_1024'][1]:.3f} Mrays/s; "
          f"{prof_e['cuda_launches']} cudaLaunchKernel calls, device idle "
          f"share {prof_e['idle_share']:.3f} (the torch sky pass: 231.5 ms, "
          f"9,918 launches, 0.777 idle) | {card}", flush=True)

    # a 10-step envmap fit at 256x256: the sky at half its brightness and
    # the albedo perturbed; the held-out loss must fall, texels stay >= 0
    st31f = st_e.replace(width=256, height=256)
    target31 = ht.render_frame(spheres, sky_cam, st31f, 0)
    true_e = spheres
    pert_e = dataclasses.replace(
        spheres, env_mips=tuple(0.5 * m for m in spheres.env_mips),
        materials=dataclasses.replace(
            spheres.materials, albedo=torch.clamp(
                spheres.materials.albedo * 0.5 + 0.2, 0.0, 1.0)))
    marks31 = [time.perf_counter()]
    fitted_e, losses_e = fit_materials(
        pert_e, sky_cam, st31f, target31, steps=10, lr=1e-2,
        optimize_env=True,
        callback=lambda i, p, l: marks31.append(time.perf_counter()))
    held31 = {
        name: float(np.mean([float(render_loss(
            {"materials": p["materials"], "env_mips": p["env_mips"]},
            true_e, sky_cam, st31f, target31, f))
            for f in range(1000, 1004)]))
        for name, p in (("perturbed", {"materials": pert_e.materials,
                                       "env_mips": pert_e.env_mips}),
                        ("fitted", fitted_e),
                        ("true", {"materials": true_e.materials,
                                  "env_mips": true_e.env_mips}))}
    min_texel = min(float(m.min()) for m in fitted_e["env_mips"])
    fit31_ms = float(np.median(np.diff(marks31))) * 1e3
    print(f"[31] fit_materials(optimize_env=True), envmap_1024 at 256x256, "
          f"10 steps: loss {losses_e[0]:.6e} -> {losses_e[-1]:.6e}; "
          f"held-out loss {held31}; smallest texel {min_texel:.4e}; median "
          f"step {fit31_ms:.1f} ms | {card}", flush=True)
    assert np.isfinite(losses_e).all(), "env fit losses not finite"
    assert held31["fitted"] < held31["perturbed"], "the env fit did not help"
    assert min_texel >= 0.0, "a texel went below 0"

    # --- 32. the light-NEE variants (B1e) vs plain, unbiasedness, noise
    from halogen_tpu_torch.integrator.trace import trace_rays

    t32 = time.perf_counter()
    print(f"[32] phases 1-31 took {t32 - t_main:.1f} s", flush=True)

    def blocked_plate():
        s32 = cornell.cornell_box(with_spheres=False)
        v32 = np.array([(-0.5, 0.2, -0.5), (0.5, 0.2, -0.5), (0.5, 0.2, 0.5),
                        (-0.5, 0.2, 0.5)], np.float32)
        s32.add_mesh(v32, np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                     ht.Material.diffuse((0.1, 0.1, 0.1)))
        return s32.build(device=dev)

    lbase = dict(width=64, height=64, samples_per_pixel=4,
                 light_importance_sampling=True)
    sky_env = dict(use_envmap=True, env_importance_sampling=True,
                   env_mip_level=0)
    testing = testing_scene.testing_scene(False).build(device=dev)
    light32 = {  # name: (variant, scene, camera, settings)
        "cornell": ("B1e", cornell.cornell_box().build(device=dev), cam,
                    ht.RenderSettings(**lbase, max_bounces=4)),
        "glow_orbs": ("B1e", cornell.glow_orbs().build(device=dev), cam,
                      ht.RenderSettings(**lbase, max_bounces=4)),
        "blocked_plate": ("B1e", blocked_plate(), cam,
                          ht.RenderSettings(**lbase, max_bounces=2)),
        "glass_box": ("B1b+e", glass, cam, ht.RenderSettings(
            **lbase, max_bounces=8, max_transmission_bounces=8)),
        "sky_env_light": ("B1c+e", sky_cornell, cam, ht.RenderSettings(
            **lbase, max_bounces=4, **sky_env)),
        "glass_dragon": ("B1b+e+d", dragon, dcam, ht.RenderSettings(
            **lbase, max_bounces=12)),
        "testing_active": ("B1e+d", testing,
                           testing_scene.testing_scene_camera(device=dev),
                           ht.RenderSettings(**lbase, max_bounces=4)),
    }
    parity32, means32 = {}, {}
    for name, (variant, sc, cm, st32) in light32.items():
        assert sc.lights is not None and mk.fused_supported(sc, st32), name
        pix = torch.arange(st32.num_pixels, device=dev)
        o32, d32, s32, e32 = rays(pix, 4, 4, st32, 1, cm)
        got = mk.trace_fused_outputs(sc, o32, d32, cm.far, s32, e32, st32)
        col = mk.trace_color_fused(sc, o32, d32, cm.far, s32, e32, st32)
        # the plain version: the lockstep on the card (its closest hits as
        # Fused.OFF takes them: brute force up to 4096 triangles, else B3)
        ref = trace_rays(sc, o32, d32, cm.far.expand(o32.shape[0]), s32, e32,
                         st32.replace(fused=ht.Fused.OFF))
        torch.cuda.synchronize()
        n32 = got.shape[0]
        # with env NEE, or on a BVH-tier scene, the final direction and the
        # continuation pdf are held where and as the sky pass reads them
        # (phase 17): on rays that reached the sky, the pdf through its MIS
        # weight
        read = (ref.outputs[:, 3:6] != 0).any(dim=1)
        as_read = mk.uses_bvh(sc) or st32.env_importance_sampling
        keep = [c for c in range(got.shape[1])
                if c != 10 and not (as_read and c in (7, 8, 9))]
        n_bad, max_out = compare(got[:, keep], ref.outputs[:, keep])
        n_bad_col, max_col = compare(col, ref.color)
        n_bad_dir = 0
        if as_read:
            n_bad_dir, _ = compare(got[read, 7:10], ref.outputs[read, 7:10])
        if got.shape[1] > 10:
            wg = env_mis_weight(sc, got)[read].cpu().numpy()
            wr = env_mis_weight(sc, ref.outputs)[read].cpu().numpy()
            bad_w = int((np.abs(wg - wr) > PARITY_TOL
                         + PDF_RTOL * np.abs(wr)).sum())
            assert bad_w <= PARITY_MAX_OUTSIDE * n32, f"{name} MIS weight"
        parity32[name] = (variant, max(max_out, max_col))
        # the frames: the kernel's route and Fused.OFF at 256x256
        st_f = st32.replace(width=256, height=256)
        before = mk.LAUNCHES
        k_img = ht.render_frame(sc, cm, st_f, 1)
        assert mk.LAUNCHES > before, f"{name} did not launch B1e"
        p_img = ht.render_frame(sc, cm, st_f.replace(fused=ht.Fused.OFF), 1)
        rel = abs(float(k_img.mean()) - float(p_img.mean())) / abs(
            float(p_img.mean()))
        means32[name] = (float(k_img.mean()), float(p_img.mean()), rel)
        print(f"[32] {name} ({variant}): {n32} rays, {got.shape[1]} "
              f"outputs; outputs max |diff| {max_out:.3e}, {n_bad} rays "
              f"outside {PARITY_TOL}; color max |diff| {max_col:.3e}, "
              f"{n_bad_col} rays outside; final direction of the rays that "
              f"reached the sky: {n_bad_dir} outside; 256x256 mean radiance "
              f"kernel {means32[name][0]:.6f} vs plain {means32[name][1]:.6f}"
              f" (rel {rel:.2e}, < 2e-2) | {card}", flush=True)
        assert n_bad <= PARITY_MAX_OUTSIDE * n32, f"parity {name} failed"
        assert n_bad_col <= PARITY_MAX_OUTSIDE * n32, f"color {name} failed"
        assert n_bad_dir <= PARITY_MAX_OUTSIDE * n32, f"direction {name}"
        assert rel < 2e-2, f"{name} frame mean disagrees with plain"

    # unbiasedness and noise (tests/test_light_nee.py:44-71) at 256x256
    cornell_d = light32["cornell"][1]
    st_u = ht.RenderSettings(width=256, height=256, samples_per_pixel=96,
                             max_bounces=3)
    brdf_hi = ht.render_frame(cornell_d, cam, st_u, 1)
    nee_hi = ht.render_frame(cornell_d, cam, st_u.replace(
        light_importance_sampling=True), 1)
    rel_u = abs(float(nee_hi.mean()) - float(brdf_hi.mean())) / float(
        brdf_hi.mean())
    lo = st_u.replace(samples_per_pixel=4)
    nee_lo = ht.render_frame(cornell_d, cam, lo.replace(
        light_importance_sampling=True), 1)
    brdf_lo = ht.render_frame(cornell_d, cam, lo, 1)
    ref_u = torch.stack([ht.render_frame(cornell_d, cam, lo.replace(
        samples_per_pixel=64, light_importance_sampling=True), f)
        for f in range(1, 4)]).mean(dim=0)
    err_nee = float((nee_lo - ref_u).abs().mean())
    err_brdf = float((brdf_lo - ref_u).abs().mean())
    print(f"[32] Cornell at 256x256, 3 bounces: 96 spp mean radiance NEE "
          f"{float(nee_hi.mean()):.6f} vs BRDF-only "
          f"{float(brdf_hi.mean()):.6f} (rel {rel_u:.3e}, < 0.06); 4 spp "
          f"mean |error| against 192 spp of NEE: NEE {err_nee:.5f}, "
          f"BRDF-only {err_brdf:.5f} (ratio {err_nee / err_brdf:.3f}, "
          f"< 0.75) | {card}", flush=True)
    assert rel_u < 0.06, "light NEE is biased against BRDF sampling"
    assert err_nee < 0.75 * err_brdf, "light NEE did not cut the noise"

    # registers, and the device time at the launch shape beside B1a (phase
    # 5's rays, Cornell glossy, 6 bounces) and B1b+d (phase 19's rays)
    light_shapes = {
        "B1e": (scene, cam, st_a.replace(light_importance_sampling=True),
                o, d, sidx, seed, "megakernel_light<", "B1a"),
        "B1b+e+d": (dragon, dcam, st_d.replace(
            light_importance_sampling=True), o_cam, d_cam, sidx_cam,
            seed_cam, "megakernel_bvh_light<", "B1b+d"),
    }
    times32 = {}
    for name, (sc, cm, st32, o32, d32, s32, e32, key, beside) in (
            light_shapes.items()):
        tab32, lt32 = mk._scene_tables(sc), mk.light_table(sc)
        kernel = lambda: mk.trace_fused_outputs(sc, o32, d32, cm.far, s32, e32,
                                                st32, tab32, None, lt32)
        small = slice(0, 16384) if mk.uses_bvh(sc) else slice(None)
        plain = lambda: trace_rays(
            sc, o32[small], d32[small], cm.far.expand(o32[small].shape[0]),
            s32[small], e32[small], st32.replace(fused=ht.Fused.OFF)).outputs
        got = kernel()
        ref = plain()
        torch.cuda.synchronize()
        n_bad, err = compare(got[small, :7], ref[:, :7])
        k_ms = [_cuda_ms(kernel, 10), _cuda_ms(kernel, 10)]
        dev_ms = profiled_ms(kernel, key, reps=5)
        p_ms = [_cuda_ms(plain, 1), _cuda_ms(plain, 1)]
        w = _path_work(sc, o32, d32, cm.far, s32, e32, st32)
        nbytes = (o32.shape[0] * (32 + 4 * got.shape[1])
                  + _table_bytes((*tab32, *lt32, sc.wbvh.nodes
                                  if mk.uses_bvh(sc) else None)))
        ops = _path_ops(w, sc.any_transmissive, False, lnee=True)
        bound = _bound(nbytes, ops)
        times32[name] = dict(ms=k_ms, device_ms=dev_ms, plain_ms=p_ms,
                             plain_rays=int(ref.shape[0]), err=err,
                             outside=int(n_bad), work=w, bytes=nbytes,
                             ops=ops, bound=bound, res=res[name])
        print(f"[32] {name}: one launch of {o32.shape[0]} rays, "
              f"{st32.max_bounces} bounces: {k_ms} ms (events), "
              f"{ms4(dev_ms)} ms (device), beside {beside} in phases 13 and "
              f"19 on the same rays; registers, spill bytes {res[name]}; "
              f"plain (the lockstep) at {ref.shape[0]} rays {p_ms} ms; "
              f"outputs 0-6 max |diff| {err:.3e}, {n_bad} rays outside; "
              f"work {w}; bound {bound[0]:.4f} ms by {bound[1]} | {card}",
              flush=True)
        assert n_bad <= PARITY_MAX_OUTSIDE * ref.shape[0], name
    print(f"[32] registers, spill-store bytes of the light-NEE variants: "
          f"{ {k: res[k] for k in sorted(light_variants)} }", flush=True)

    # B1e+d's light shadow rays through the light-NEE probe (a measurement
    # variant of the kernel that runs both walks of every light shadow ray
    # and counts them): on phase 32's BVH-tier scenes and at the glass
    # dragon's launch shape. With the any-hit walk (the kernel's) deciding
    # it must give the kernel's bits; with the closest-hit walk deciding (the rule the
    # any-hit walk replaced) its outputs may part from the kernel's only on
    # rays where the two decisions differed, which it counts, and of those
    # the exact ties in t. Then the launch shape's walks timed alone, in
    # turns with the kernel (the probe's "no test": every draw visible).
    col = {k: i for i, k in enumerate(mk.PROBE_COUNTERS)}
    pix32 = torch.arange(64 * 64, device=dev)
    st_dl = st_d.replace(light_importance_sampling=True)
    cases_p = {
        "glass_dragon (B1b+e+d)": (dragon, dcam, light32["glass_dragon"][3],
                                   rays(pix32, 4, 4,
                                        light32["glass_dragon"][3], 1,
                                        dcam)),
        "testing_active (B1e+d)": (
            testing, light32["testing_active"][2],
            light32["testing_active"][3],
            rays(pix32, 4, 4, light32["testing_active"][3], 1,
                 light32["testing_active"][2])),
        "glass_dragon at the launch shape (B1b+e+d)": (
            dragon, dcam, st_dl, (o_cam, d_cam, sidx_cam, seed_cam)),
    }
    probe32 = {}
    for name, (sc, cm, stp, (o_p, d_p, s_p, e_p)) in cases_p.items():
        tab_p, lt_p = mk._scene_tables(sc), mk.light_table(sc)
        new = mk.trace_fused_outputs(sc, o_p, d_p, cm.far, s_p, e_p, stp,
                                     tab_p, None, lt_p)
        out_a, c_a = mk.light_probe(sc, o_p, d_p, cm.far, s_p, e_p, stp,
                                    "kernel", tab_p, lt_p)
        out_c, c_c = mk.light_probe(sc, o_p, d_p, cm.far, s_p, e_p, stp,
                                    "closest", tab_p, lt_p)
        torch.cuda.synchronize()
        apart = (out_c != new).any(dim=1)
        differ = c_c[:, col["decisions_differ"]] > 0
        tied = c_c[:, col["ties"]] > 0
        tot = c_c.sum(dim=0).tolist()
        walks = max(tot[col["shadow_rays"]], 1)
        probe32[name] = dict(
            rays=int(o_p.shape[0]), shadow_rays=tot[col["shadow_rays"]],
            blocked_share=tot[col["blocked"]] / walks,
            tests_per_walk_closest=[tot[col["tri_tests_closest"]] / walks,
                                    tot[col["box_tests_closest"]] / walks],
            tests_per_walk_any=[tot[col["tri_tests_kernel"]] / walks,
                                tot[col["box_tests_kernel"]] / walks],
            decisions_differ=tot[col["decisions_differ"]],
            ties=tot[col["ties"]], rays_apart=int(apart.sum()),
            rays_apart_with_a_tie=int((apart & tied).sum()),
            probe_equals_kernel=torch.equal(out_a, new))
        print(f"[32] {name}: light shadow rays through the probe: "
              f"{probe32[name]} (tests per walk: [triangles, boxes]; the "
              f"closest-hit walk as the rule it replaced ran it) | {card}",
              flush=True)
        assert probe32[name]["probe_equals_kernel"], name
        assert bool(differ[apart].all()), name
    tab_p, lt_p = mk._scene_tables(dragon), mk.light_table(dragon)
    split_fns = {
        "B1b+e+d": lambda: mk.trace_fused_outputs(
            dragon, o_cam, d_cam, dcam.far, sidx_cam, seed_cam, st_dl, tab_p,
            None, lt_p),
        **{f"probe: {m}": (lambda m=m: mk.light_probe(
            dragon, o_cam, d_cam, dcam.far, sidx_cam, seed_cam, st_dl, m,
            tab_p, lt_p))
          for m in ("no test", "closest only", "kernel only")}}
    split32 = {k: [] for k in split_fns}
    for order in (list(split_fns), list(split_fns)[::-1]):
        for k in order:
            split_fns[k]()
            split32[k].append(_cuda_ms(split_fns[k], 5))
    print(f"[32] the glass dragon's light-NEE launch (B1b+e+d, {n28} rays, "
          f"12 bounces), ms (events, in turns): {split32}; B1b+d beside it "
          f"(phase 19): {b1d['B1b+d']['ms']} | {card}", flush=True)

    # B1e's light shadow rays through the brute tier's probe, which runs
    # both scans of every light shadow ray and counts them: the full one
    # (Möller-Trumbore on every triangle, B1e's rule before the cull) and
    # the culled one (B1e's). On the Cornell box, glow_orbs, the blocked
    # plate and the glass box (B1b+e; 64x64 x 4 lanes) and at the launch
    # shape of Cornell glossy and of glow_orbs (phase 5's rays, 6
    # bounces): deciding by either it must give the kernel's bits, its two
    # decisions never apart. B1e's bound then counts the culled scan's
    # work on the launch shape's rays: each light shadow ray's plane tests
    # and the Möller-Trumbore tests they let through, where the full
    # scan's (the bound of earlier PRs, kept beside it) counts 12 of those.
    # Then each launch shape's split, in turns with B1a and B1e: every
    # draw visible ("no test"), the full scan alone, the culled scan alone.
    st_al = st_a.replace(light_importance_sampling=True)
    orbs = light32["glow_orbs"][1]
    cases_b = {
        **{f"{k} ({light32[k][0]})": (
            light32[k][1], cam, light32[k][3],
            rays(pix32, 4, 4, light32[k][3], 1, cam))
           for k in ("cornell", "glow_orbs", "blocked_plate", "glass_box")},
        "cornell_glossy at the launch shape (B1e)": (
            scene, cam, st_al, (o, d, sidx, seed)),
        "glow_orbs at the launch shape (B1e)": (
            orbs, cam, st_al, (o, d, sidx, seed)),
    }
    probe32b, totals32b = {}, {}
    for name, (sc, cm, stp, (o_p, d_p, s_p, e_p)) in cases_b.items():
        tab_p, lt_p = mk._scene_tables(sc), mk.light_table(sc)
        new = mk.trace_fused_outputs(sc, o_p, d_p, cm.far, s_p, e_p, stp,
                                     tab_p, None, lt_p)
        out_c, c_c = mk.light_probe(sc, o_p, d_p, cm.far, s_p, e_p, stp,
                                    "closest", tab_p, lt_p)
        out_u, c_u = mk.light_probe(sc, o_p, d_p, cm.far, s_p, e_p, stp,
                                    "kernel", tab_p, lt_p)
        torch.cuda.synchronize()
        tot = c_u.sum(dim=0).tolist()
        walks = max(tot[col["shadow_rays"]], 1)
        probe32b[name] = dict(
            rays=int(o_p.shape[0]), shadow_rays=tot[col["shadow_rays"]],
            blocked_share=tot[col["blocked"]] / walks,
            mt_tests_per_shadow_ray_full=tot[col["tri_tests_closest"]]
            / walks,
            mt_tests_per_shadow_ray_culled=tot[col["tri_tests_kernel"]]
            / walks,
            culls_per_shadow_ray=tot[col["tris_culled"]] / walks,
            culled_share=tot[col["tris_culled"]] / max(
                tot[col["tri_tests_closest"]], 1),
            decisions_differ=tot[col["decisions_differ"]],
            decisions_differ_closest=int(
                c_c[:, col["decisions_differ"]].sum()),
            rays_apart=int((out_c != new).any(dim=1).sum()),
            closest_equals_kernel=torch.equal(out_c, new),
            culled_equals_kernel=torch.equal(out_u, new))
        print(f"[32] {name}: light shadow rays through the brute probe: "
              f"{probe32b[name]} | {card}", flush=True)
        assert probe32b[name]["closest_equals_kernel"], name
        assert probe32b[name]["culled_equals_kernel"], name
        assert probe32b[name]["decisions_differ"] == 0, name
        assert probe32b[name]["decisions_differ_closest"] == 0, name
        totals32b[name] = tot
    # B1e's bound from the culled scan (phase 32's B1e timed these rays)
    t_e = times32["B1e"]
    tot = totals32b["cornell_glossy at the launch shape (B1e)"]
    w = t_e["work"]
    ops_full = _path_ops(w, scene.any_transmissive, False, lnee=True)
    ops_culled = (ops_full - w["lshadow"] * scene.num_triangles * OPS_TRI
                  + tot[col["tri_tests_kernel"]] * OPS_TRI
                  + (tot[col["tri_tests_kernel"]] + tot[col["tris_culled"]])
                  * OPS_CULL)
    t_e["bound_full_scan"] = t_e["bound"]
    t_e["bound"] = _bound(t_e["bytes"], ops_culled)
    t_e["ops"] = ops_culled
    print(f"[32] B1e's bound from the culled scan's work: "
          f"{t_e['bound'][0]:.4f} ms by {t_e['bound'][1]} ({ops_culled:.4g} "
          f"operations; the full scan's, as counted before the cull: "
          f"{t_e['bound_full_scan'][0]:.4f} ms, {ops_full:.4g}); the "
          f"kernel {ms4(t_e['device_ms'])} ms (device) | {card}", flush=True)
    split32b = {}
    for sname, sc in (("cornell_glossy", scene), ("glow_orbs", orbs)):
        tab_p, lt_p = mk._scene_tables(sc), mk.light_table(sc)
        fns = {
            "B1a": lambda sc=sc, tab_p=tab_p: mk.trace_fused_outputs(
                sc, o, d, cam.far, sidx, seed, st_a, tab_p),
            "B1e": lambda sc=sc, tab_p=tab_p, lt_p=lt_p:
                mk.trace_fused_outputs(sc, o, d, cam.far, sidx, seed, st_al,
                                       tab_p, None, lt_p),
            **{f"probe: {m}": (lambda sc=sc, m=m, tab_p=tab_p, lt_p=lt_p:
                               mk.light_probe(sc, o, d, cam.far, sidx, seed,
                                              st_al, m, tab_p, lt_p))
               for m in ("no test", "closest only", "kernel only")}}
        split32b[sname] = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                fns[k]()
                split32b[sname][k].append(_cuda_ms(fns[k], 5))
        print(f"[32] B1e's split on {sname} ({o.shape[0]} rays, 6 bounces), "
              f"ms (events, in turns): {split32b[sname]} | {card}",
              flush=True)

    # its gradient on the card (B2+l; phase 36 holds it to plain): a step
    # of the Cornell case is one recording B1e and one light sweep a group,
    # no replay
    counts32 = lambda: (mk.LAUNCHES, mk.RECORD_LAUNCHES, adj.LAUNCHES,
                        adj.SWEEP_LAUNCHES)
    before = counts32()
    loss32, g32 = render_loss_grad(
        {"materials": cornell_d.materials}, cornell_d, cam,
        light32["cornell"][3], torch.zeros((64, 64, 3), device=dev), 1)
    launched32 = tuple(a - b for a, b in zip(counts32(), before))
    assert (launched32[0] == launched32[1] == launched32[3] > 0
            and launched32[2] == 0), launched32
    assert bool(torch.isfinite(loss32)) and float(
        g32["materials"].emissive.abs().max()) > 0
    print(f"[32] render_loss_grad with light NEE on the card: launches "
          f"(megakernel, recording, replay, sweep) {launched32}: the "
          f"recording B1e and the light sweep (B2+l), no replay",
          flush=True)

    # --- 33. light NEE at full width
    full33 = {  # name: (scene, camera, settings, frames timed)
        "cornell_glossy": (scene, cam, st_a.replace(
            samples_per_pixel=32, light_importance_sampling=True), 2),
        "glow_orbs": (light32["glow_orbs"][1], cam, st_a.replace(
            samples_per_pixel=32, light_importance_sampling=True), 2),
        "glass_dragon": (dragon, dcam, st_d.replace(
            light_importance_sampling=True), 2),
    }
    main33 = {}
    for name, (sc, cm, st33, n_frames) in full33.items():
        mk.LAUNCHES = adj.LAUNCHES = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ht.render_frame(sc, cm, st33, 0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames33 = [ht.render_frame(sc, cm, st33, f + 1)
                    for f in range(n_frames)]
        torch.cuda.synchronize()
        dt33 = time.perf_counter() - t0
        peak33 = torch.cuda.max_memory_allocated()
        launches33 = mk.LAUNCHES
        assert launches33 > 0 and adj.LAUNCHES == 0, name
        for img in frames33:
            assert img.shape == (st33.height, st33.width, 3)
            assert bool(torch.isfinite(img).all()), f"{name} not finite"
        mr33 = st33.samples_per_pixel * st33.num_pixels * n_frames / dt33 / 1e6
        prof33 = _profile_step(
            lambda: ht.render_frame(sc, cm, st33, n_frames + 1),
            dt33 / n_frames * 1e3)
        main33[name] = dict(launches=launches33, frame_ms=dt33 / n_frames
                            * 1e3, mrays_per_s=mr33, profile=prof33,
                            peak_bytes=peak33)
        if name == "glass_dragon":  # its first group's light shadow rays
            print(f"[33] glass_dragon: the light shadow rays of its frame's "
                  f"first group (phase 32's launch shape): "
                  f"{probe32['glass_dragon at the launch shape (B1b+e+d)']}",
                  flush=True)
        print(f"[33] {name} with light NEE {st33.width}x{st33.height} "
              f"{st33.samples_per_pixel} spp {st33.max_bounces} bounces: "
              f"{launches33} kernel launches in {n_frames + 1} frames; "
              f"{n_frames} frames in {dt33:.4f} s = {mr33:.3f} Mrays/s; "
              f"{_profile_text(prof33)}; peak memory "
              f"{peak33 / 2**30:.3f} GiB | {card}", flush=True)

    # --- 34. the CLI on the card, in this process
    from halogen_tpu_torch.cli.main import main as cli

    tmp34 = tempfile.TemporaryDirectory()
    out34 = pathlib.Path(tmp34.name)

    def wrote(path):  # a PNG, or the linear .npy where there is no PIL
        return path.exists() or pathlib.Path(str(path) + ".npy").exists()

    import contextlib
    import io

    cli34 = {}
    for name, argv in (
            ("render cornell_glossy_512 light NEE",
             ["render", "--preset", "cornell_glossy_512", "--light-nee",
              "--frames", "2", "--out", str(out34 / "cornell.png")]),
            ("bench glass_dragon light NEE",
             ["bench", "--preset", "glass_dragon", "--light-nee"]),
            ("debug-sobol", ["debug-sobol", "--out", str(out34 / "s.png")]),
            ("fit", ["fit", "--steps", "3", "--width", "64", "--out",
                     str(out34 / "fit.png")]),
            ("fit light NEE", ["fit", "--light-nee", "--steps", "3",
                               "--width", "64", "--out",
                               str(out34 / "fit_light.png")])):
        mk.LAUNCHES = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        torch.cuda.synchronize()
        cli34[name] = (rc, time.perf_counter() - t0, mk.LAUNCHES,
                       buf.getvalue().strip())
        print(f"[34] {name}: rc {rc}, {cli34[name][1]:.2f} s, "
              f"{mk.LAUNCHES} megakernel launches; stdout "
              f"{cli34[name][3][-200:]!r}", flush=True)
        assert rc == 0, name
    assert cli34["render cornell_glossy_512 light NEE"][2] > 0
    assert wrote(out34 / "cornell.png") and wrote(out34 / "s.png")
    bench34 = json.loads(cli34["bench glass_dragon light NEE"][3]
                         .splitlines()[-1])
    assert set(bench34) == {"metric", "value", "unit", "vs_baseline"}
    assert bench34["value"] > 0 and bench34["unit"] == "Mrays/s/cuda"
    for name in ("fit", "fit light NEE"):
        fit34 = json.loads(cli34[name][3].splitlines()[-1])
        assert np.isfinite([fit34["initial_loss"],
                            fit34["final_loss"]]).all(), name
        assert cli34[name][2] > 0, name  # on the kernels
    ck34 = out34 / "state.npz"
    for _ in range(2):
        assert cli(["render", "--width", "64", "--spp", "2", "--frames", "2",
                    "--light-nee", "--out", str(out34 / "ck.png"),
                    "--checkpoint", str(ck34)]) == 0
    frame_count = int(np.load(ck34)["frame_count"])
    assert frame_count >= 3, frame_count  # resumed past the first run
    mk.LAUNCHES = 0
    assert cli(["render", "--sharded", "--width", "64", "--spp", "2",
                "--out", str(out34 / "x.png")]) == 0
    assert wrote(out34 / "x.png") and mk.LAUNCHES > 0
    tmp34.cleanup()
    print(f"[34] a checkpoint resumed to frame_count {frame_count}; "
          f"--sharded renders over a group of one ({mk.LAUNCHES} megakernel "
          f"launches); bench {bench34}; phases 32-34 took "
          f"{time.perf_counter() - t32:.1f} s | {card}", flush=True)

    # --- 35. the brute tier's record route at its launch shapes: phase
    # 28's checks for B2 (phase 5's Cornell rays, 6 bounces), B2b (phase
    # 13's glass rays, 8 bounces), B2c and B2c+n (the envmap_1024 rays of
    # phases 13 and 29, 4 bounces, without and with env NEE) and B2b+c+n
    # (the glass rays under the sky with env NEE)
    t35 = time.perf_counter()
    glass_nee = st_g.replace(use_envmap=True, env_importance_sampling=True,
                             env_mip_level=0)
    g35 = torch.Generator().manual_seed(35)
    ct_g35 = torch.rand((o_g.shape[0], 3), generator=g35).to(dev)
    ct_e35 = torch.rand((o_e.shape[0], 3), generator=g35).to(dev)
    glass_frame2 = list(rays(pix_g[::16], 1, 32, st_g, 2, cam))
    glass_frame2.insert(2, cam.far)
    cases35 = {  # name: (scene, settings, rays, ct, forward variant)
        "B2": (scene, st_a, (o, d, cam.far, sidx, seed), ct, "B1a"),
        "B2b": (glass, st_g, (o_g, d_g, cam.far, sidx_g, seed_g), ct_g35,
                "B1b"),
        "B2c": (spheres, st_e.replace(env_importance_sampling=False),
                (o_e, d_e, sky_cam.far, sidx_e, seed_e), ct_e35, "B1a"),
        "B2c+n": (spheres, st_e, (o_e, d_e, sky_cam.far, sidx_e, seed_e),
                  ct_e35, "B1c"),
        "B2b+c+n": (glass_sky, glass_nee,
                    (o_g, d_g, cam.far, sidx_g, seed_g), ct_g35, "B1b+c"),
    }
    rec35 = {}
    for name, (sc, st35, r35, c35, fwd_v) in cases35.items():
        assert not mk.uses_bvh(sc), name
        rec35[name] = record_route("35", name, sc, st35, r35, c35, fwd_v,
                                   glass_frame2)
    print(f"[35] the brute tier's record route: "
          f"{ {k: dict(sweep_ms=v['times']['sweep'][0], replay_ms=v['times']['replay'][0], forward_ms=v['times']['forward'][0], forward_record_ms=v['times']['forward with the record'][0], bound_ms=v['bound'][0]) for k, v in rec35.items()} }"
          f"; phase 35 took {time.perf_counter() - t35:.1f} s | {card}",
          flush=True)

    # --- 36. the light-NEE adjoint (B2+l): the recording B1e and the light
    # sweep against their plain versions on seven scenes, 64x64 x 4 lanes;
    # then their times at the launch shapes, the three full-width fwd+bwd
    # steps with light NEE and a glow_orbs fit
    t36 = time.perf_counter()
    cases36 = {  # name: (forward variant, scene, camera, settings)
        **{k: light32[k] for k in ("cornell", "glow_orbs", "blocked_plate",
                                   "glass_box", "sky_env_light")},
        "metal_dragon": ("B1e+d", metal_dragon, dcam,
                         ht.RenderSettings(**lbase, max_bounces=12)),
        "glass_dragon": light32["glass_dragon"],
    }
    g36 = torch.Generator().manual_seed(36)
    check36 = {}
    for name, (variant, sc, cm, st36) in cases36.items():
        pix = torch.arange(st36.num_pixels, device=dev)
        o36, d36, s36, e36 = rays(pix, 4, 4, st36, 1, cm)
        r36 = (o36, d36, cm.far, s36, e36)
        n36 = o36.shape[0]
        tab, et, lt = (mk._scene_tables(sc), mk.env_table(sc),
                       mk.light_table(sc))
        env = adj.env_mode(sc, st36)
        nee = env == 2
        ct36 = torch.rand((n36, 3), generator=g36).to(dev)
        gsky36 = torch.rand((n36, 4), generator=g36).to(dev) if env else None
        rec = mk.empty_record(n36, st36, nee, dev, True)
        before = mk.RECORD_LAUNCHES
        out_rec = mk.trace_fused_outputs(sc, *r36, st36, tab, et, lt,
                                         record=rec)
        out = mk.trace_fused_outputs(sc, *r36, st36, tab, et, lt)
        assert mk.RECORD_LAUNCHES == before + 1, name

        def nee_bufs():
            slots = st36.max_bounces + 1
            return ((torch.empty((n36, slots), dtype=torch.int32,
                                 device=dev),
                     torch.empty((n36, slots, 3), device=dev))
                    if nee else None)

        before = adj.SWEEP_LAUNCHES, adj.LAUNCHES
        recs_a, recs_b = nee_bufs(), nee_bufs()
        got = adj._launch(sc, None, None, None, None, None, ct36, st36, tab,
                          gsky=gsky36, env_tab=et, records=recs_a,
                          record=rec)
        again = adj._launch(sc, None, None, None, None, None, ct36, st36,
                            tab, gsky=gsky36, env_tab=et, records=recs_b,
                            record=rec)
        torch.cuda.synchronize()
        assert (adj.SWEEP_LAUNCHES, adj.LAUNCHES) == (before[0] + 2,
                                                      before[1]), name
        fwd_same = torch.equal(out_rec, out)
        repeat = torch.equal(got, again) and (not nee or (
            torch.equal(recs_a[0], recs_b[0])
            and torch.equal(recs_a[1][recs_a[0] >= 0],
                            recs_b[1][recs_b[0] >= 0])))
        # the sweep against its plain version on the same record
        d_out = torch.cat([ct36, gsky36 if env else torch.zeros(
            (n36, 4), device=dev)], dim=1)
        ref_s, ref_recs = adj.sweep_reference(sc, st36, rec, d_out)
        sweep_err, sweep_ratio = _grad_compare(got, ref_s)
        tight = float(((got - ref_s).abs() / (
            1e-5 * ref_s.abs().amax(dim=0) + 1e-7)).max())
        # the record against the lockstep's, where the forwards agree;
        # the light words hold the glossy pdf (through the MIS weights), as
        # env NEE's do: floats past 1e-4 on at most 0.1% of the rays where
        # the scene has glass, a glossy lobe or env NEE
        c36 = _record_vs_plain(sc, st36, r36, rec, out_rec)
        agree = c36["agree"]
        glossy = bool((sc.materials.metallic > 0).any())
        rec_ok = (c36["ids"] == 0 and int((~agree).sum())
                  <= 0.01 * agree.shape[0] and c36["floats"] <= (
                      PARITY_MAX_OUTSIDE * agree.shape[0]
                      if sc.any_transmissive or nee or glossy else 0))
        n_sh = rec.end.to(torch.int64) & 0xFFFF
        slot = torch.arange(rec.word.shape[0], device=dev)[:, None]
        lit = (slot < n_sh[None]) & ((rec.word.to(torch.int64)
                                      & (1 << 27)) != 0)
        # the route against the plain backward: render_loss_grad against
        # Fused.OFF's autograd through the lockstep on the card, each
        # route's target its own image + c, c zero on the pixels whose
        # forwards round apart
        params36 = {"materials": sc.materials}
        img_k = ht.render_frame(sc, cm, st36, 1)
        img_p = ht.render_frame(sc, cm, st36.replace(fused=ht.Fused.OFF), 1)
        agree_px = ((img_k - img_p).abs() <= PARITY_TOL + PARITY_TOL
                    * img_p.abs()).all(dim=2, keepdim=True)
        assert int((~agree_px).sum()) <= PARITY_MAX_OUTSIDE * (
            agree_px.numel()), name
        c36px = torch.rand(tuple(img_k.shape), generator=g36).to(dev) * (
            agree_px)
        before = counts32()
        _, g_k = render_loss_grad(params36, sc, cm, st36, img_k + c36px, 1)
        launched = tuple(a - b for a, b in zip(counts32(), before))
        _, g_p = render_loss_grad(params36, sc, cm,
                                  st36.replace(fused=ht.Fused.OFF),
                                  img_p + c36px, 1)
        route36 = {}
        for f in ("albedo", "specular", "emissive", "absorption",
                  "roughness", "metallic", "ior"):
            route36[f] = _grad_compare(getattr(g_k["materials"], f),
                                       getattr(g_p["materials"], f))
        check36[name] = dict(
            variant=variant, rays=n36, fwd_same=fwd_same, repeat=repeat,
            sweep_max_abs_err=sweep_err, sweep_worst_ratio=sweep_ratio,
            sweep_worst_ratio_1e5=tight, lit_bounces=int(lit.sum()),
            record_rays_held_out=int((~agree).sum()),
            record_ids_apart=c36["ids"], record_floats_apart=c36["floats"],
            record_max_rel_err=c36["err"], record_drift=c36["drift"],
            step_launches=launched,
            route_vs_plain={k: v[0] for k, v in route36.items()},
            route_worst_ratio=max(v[1] for v in route36.values()),
            pixels_apart=int((~agree_px).sum()))
        print(f"[36] {name} ({variant} recording, B2+l): {n36} rays, "
              f"{check36[name]['lit_bounces']} lit bounces; outputs with "
              f"the record == without {fwd_same}; the sweep bitwise "
              f"repeatable {repeat}, vs sweep_reference max |diff| "
              f"{sweep_err:.3e}, worst diff/bound {sweep_ratio:.3e} "
              f"(phase 7's, <= 1; at 1e-5 of the column {tight:.3e}); the "
              f"record vs the lockstep's on {agree.shape[0]} rays "
              f"({check36[name]['record_rays_held_out']} held out): ids or "
              f"masks apart {c36['ids']} (none), floats apart "
              f"{c36['floats']} {c36['drift']}, max |diff| / (1 + |plain|) "
              f"{c36['err']:.3e}; render_loss_grad launches (megakernel, "
              f"recording, replay, sweep) {launched}, vs Fused.OFF max "
              f"|diff| {check36[name]['route_vs_plain']}, worst diff/bound "
              f"{check36[name]['route_worst_ratio']:.3e} (<= 1; "
              f"{check36[name]['pixels_apart']} pixels held out) | {card}",
              flush=True)
        assert fwd_same and repeat and rec_ok, name
        assert sweep_ratio <= 1.0 and check36[name]["lit_bounces"] > 0, name
        assert launched[1] == launched[3] > 0 and launched[2] == 0, name
        assert check36[name]["route_worst_ratio"] <= 1.0, name
        # glow_orbs: the emitters' d emission, which few paths shade
        if name == "glow_orbs":
            em = sc.materials.emissive
            emitters = torch.nonzero(em[:, 3] > 0).flatten()
            assert float(g_k["materials"].emissive[emitters].abs().amax(
                dim=1).min()) > 0, name

    # the recording forwards and the light sweep at the launch shapes:
    # B1e on phase 5's rays (Cornell glossy, 6 bounces) and B1b+e+d on the
    # glass dragon's (12 bounces), each in turns with its forward without
    # the record (phase 32's B1e and B1b+e+d); the light sweep (B2+l) over
    # the Cornell record, beside its plain version; their bounds
    times36 = {}
    for name, (sc, cm, st36, r36, base, key) in {
            "B1e recording": (scene, cam, st_al, (o, d, cam.far, sidx, seed),
                              "B1e", "megakernel_light_record<"),
            "B1e+d recording": (dragon, dcam, st_dl,
                                (o_cam, d_cam, dcam.far, sidx_cam,
                                 seed_cam), "B1b+e+d",
                                "megakernel_bvh_light_record<")}.items():
        tab, lt = mk._scene_tables(sc), mk.light_table(sc)
        n36 = r36[0].shape[0]
        rec = mk.empty_record(n36, st36, False, dev, True)
        fns = {"forward": lambda sc=sc, r36=r36, st36=st36, tab=tab, lt=lt:
               mk.trace_fused_outputs(sc, *r36, st36, tab, None, lt),
               "recording": lambda sc=sc, r36=r36, st36=st36, tab=tab,
               lt=lt, rec=rec: mk.trace_fused_outputs(
                   sc, *r36, st36, tab, None, lt, record=rec)}
        turns = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                fns[k]()
                turns[k].append(_cuda_ms(fns[k], 5))
        dev_ms = profiled_ms(fns["recording"], key, reps=5)
        small = slice(0, 16384) if mk.uses_bvh(sc) else slice(None)
        sub = [x[small] if x.dim() else x for x in r36]
        plain = lambda sc=sc, sub=sub, st36=st36: (
            adj.record_transcript_reference(sc, *sub, st36))
        p_ms = [_cuda_ms(plain, 1), _cuda_ms(plain, 1)]
        out_rec = fns["recording"]()
        c36 = _record_vs_plain(sc, st36, sub, mk.Record(*(
            None if t is None else (t[small] if t.dim() == 1 else t[:, small])
            for t in rec)), out_rec[small])
        shaded = int((rec.end.to(torch.int64) & 0xFFFF).sum())
        words = adj.record_words(sc, st36)
        t_b = times32[base]
        written = shaded * 4 * words + 4 * n36
        bound = _bound(t_b["bytes"] + written, t_b["ops"])
        times36[name] = dict(
            ms=turns["recording"], forward_ms=turns["forward"],
            device_ms=dev_ms, plain_ms=p_ms, plain_rays=int(sub[0].shape[0]),
            err=c36["err"], ids_apart=c36["ids"], floats_apart=c36["floats"],
            bound=bound, shaded=shaded, record_written_bytes=written,
            record_bytes=adj.record_bytes(sc, st36, n36),
            res=res[f"{base} record"], forward_res=res[base], timed=base)
        print(f"[36] {name} ({base} with the record) at {n36} rays, "
              f"{st36.max_bounces} bounces: ms (events, in turns) {turns}, "
              f"{ms4(dev_ms)} ms (device); registers, spill bytes "
              f"{res[f'{base} record']} (without the record {res[base]}); "
              f"its plain version (record_transcript_reference) at "
              f"{sub[0].shape[0]} rays {p_ms} ms, ids or masks apart "
              f"{c36['ids']}, floats apart {c36['floats']}, max |diff| / "
              f"(1 + |plain|) {c36['err']:.3e}; {shaded} shaded bounces, "
              f"record {times36[name]['record_bytes'] / 1e6:.1f} MB a "
              f"launch; bound {bound[0]:.4f} ms by {bound[1]} | {card}",
              flush=True)
        assert c36["ids"] == 0, name
        if name == "B1e recording":
            rec_c, ct_c = rec, torch.rand((n36, 3), generator=g36).to(dev)
            sc_c, st_c36, tab_c = sc, st36, tab
    sweep36 = lambda: adj._launch(sc_c, None, None, None, None, None, ct_c,
                                  st_c36, tab_c, record=rec_c)
    sweep36_plain = lambda: adj.sweep_reference(
        sc_c, st_c36, rec_c, torch.cat([ct_c, torch.zeros(
            (ct_c.shape[0], 4), device=dev)], dim=1))
    got36, ref36 = sweep36(), sweep36_plain()[0]
    err36, ratio36 = _grad_compare(got36, ref36)
    assert ratio36 <= 1.0 and torch.equal(got36, sweep36())
    sweep36()
    s_ms = [_cuda_ms(sweep36, 5), _cuda_ms(sweep36, 5)]
    s_dev = profiled_ms(sweep36, "adjoint_sweep<", reps=5)
    sp_ms = [_cuda_ms(sweep36_plain, 1), _cuda_ms(sweep36_plain, 1)]
    # the sweep's bound, counted as phase 28's: the words of the shaded
    # bounces, a ray's end word and cotangent, the table, the partials and
    # the result, against its flops (the light term's too)
    n_c = ct_c.shape[0]
    shaded_c = times36["B1e recording"]["shaded"]
    kmat = sc_c.materials.count
    blocks = -(-n_c // adj.THREADS)
    sweep_bytes = (shaded_c * 4 * adj.record_words(sc_c, st_c36)
                   + n_c * (4 + 12) + 4 * kmat * 17
                   + 4 * (blocks + 1) * kmat * 12)
    bound36 = _bound(sweep_bytes, shaded_c * (OPS_SWEEP + OPS_SWEEP_LIGHT))
    times36["B2+l"] = dict(
        ms=s_ms, device_ms=s_dev, plain_ms=sp_ms, err=err36, ratio=ratio36,
        bound=bound36, shaded=shaded_c, res=res["B2+l sweep"],
        ops_ms=shaded_c * (OPS_SWEEP + OPS_SWEEP_LIGHT) / PEAK_FLOPS * 1e3,
        bytes=sweep_bytes)
    print(f"[36] B2+l, the light sweep over the Cornell glossy record "
          f"({n_c} rays, {shaded_c} shaded bounces): {s_ms} ms (events), "
          f"{ms4(s_dev)} ms (device); registers, spill bytes "
          f"{res['B2+l sweep']}; plain (sweep_reference) {sp_ms} ms, max "
          f"|diff| {err36:.3e}, worst diff/bound {ratio36:.3e}; bound "
          f"{bound36[0]:.4f} ms by {bound36[1]} (its flops alone "
          f"{times36['B2+l']['ops_ms']:.4f} ms) | {card}", flush=True)

    # the full-width fwd+bwd steps with light NEE: bench.py's Cornell step
    # (256x256, 256 spp, 6 bounces), glow_orbs so, the glass dragon (512x512,
    # 32 spp, 12 bounces); each a warm-up and 2 timed steps, every group a
    # recording forward and a light sweep, no replay
    orbs36 = light32["glow_orbs"][1]
    st36l = st9.replace(light_importance_sampling=True)
    zeros36 = torch.zeros((256, 256, 3), device=dev)
    zeros36d = torch.zeros((st_dl.height, st_dl.width, 3), device=dev)
    jobs36 = {  # name: (scene, camera, settings, target)
        "cornell_glossy_256_fwd_bwd_light": (scene, cam, st36l, zeros36),
        "glow_orbs_256_fwd_bwd_light": (orbs36, cam, st36l, zeros36),
        "glass_dragon_512_fwd_bwd_light": (dragon, dcam, st_dl, zeros36d),
    }
    steps36 = {}
    for name, (sc, cm, st36, tgt) in jobs36.items():
        fn = (lambda f, sc=sc, cm=cm, st36=st36, tgt=tgt: render_loss_grad(
            {"materials": sc.materials}, sc, cm, st36, tgt, f))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dt36, counts, outs = timed_steps(fn, 2)
        torch.cuda.synchronize()
        peak36 = torch.cuda.max_memory_allocated()
        prof36 = _profile_step(lambda: fn(3), dt36 * 1e3)
        for loss, grads in outs:
            assert bool(torch.isfinite(loss)), name
            for f in dataclasses.fields(grads["materials"]):
                g = getattr(grads["materials"], f.name)
                assert bool(torch.isfinite(g.float()).all()), (name, f.name)
        assert (counts["megakernel"] == counts["record"] == counts["sweep"]
                > 0 and counts["adjoint"] == 0), (name, counts)
        mr36 = st36.samples_per_pixel * st36.num_pixels / dt36 / 1e6
        steps36[name] = dict(step_ms=dt36 * 1e3, mrays_fwd_bwd=mr36,
                             launches=counts, profile=prof36,
                             peak_bytes=peak36,
                             record_bytes=adj.record_bytes(
                                 sc, st36, 262144) * counts["record"] // 3)
        print(f"[36] {name} {st36.width}x{st36.height} "
              f"{st36.samples_per_pixel} spp {st36.max_bounces} bounces: "
              f"{counts} launches in 3 steps; step {dt36 * 1e3:.1f} ms = "
              f"{mr36:.3f} Mrays/s (fwd+bwd); {_profile_text(prof36)}; "
              f"records {steps36[name]['record_bytes'] / 1e9:.2f} GB a step, "
              f"peak memory {peak36 / 2**30:.3f} GiB | {card}", flush=True)

    # a 10-step fit of glow_orbs with light NEE at 256x256 from a perturbed
    # albedo and emission: the held-out loss must fall
    st36f = st36l.replace(samples_per_pixel=16)
    target36 = ht.render_frame(orbs36, cam, st36f, 0)
    mats36 = orbs36.materials
    pert36 = dataclasses.replace(
        mats36, albedo=torch.clamp(mats36.albedo * 0.5 + 0.2, 0.0, 1.0),
        emissive=torch.cat([mats36.emissive[:, :3] * 0.7,
                            mats36.emissive[:, 3:]], dim=1))
    before = counts32()
    marks36 = [time.perf_counter()]
    fitted36, losses36 = fit_materials(
        dataclasses.replace(orbs36, materials=pert36), cam, st36f, target36,
        steps=10, lr=5e-2,
        callback=lambda i, p, l: marks36.append(time.perf_counter()))
    fit_launched = tuple(a - b for a, b in zip(counts32(), before))
    held36 = {k: float(np.mean([float(render_loss(
        {"materials": m}, orbs36, cam, st36f, target36, f))
        for f in range(1000, 1004)]))
        for k, m in (("perturbed", pert36), ("fitted", fitted36["materials"]),
                     ("true", mats36))}
    fit36_ms = float(np.median(np.diff(marks36))) * 1e3
    print(f"[36] fit_materials with light NEE, glow_orbs at 256x256 16 spp, "
          f"10 steps: launches (megakernel, recording, replay, sweep) "
          f"{fit_launched}; loss {losses36[0]:.6e} -> {losses36[-1]:.6e}; "
          f"held-out loss {held36}; median step {fit36_ms:.1f} ms; phase 36 "
          f"took {time.perf_counter() - t36:.1f} s | {card}", flush=True)
    assert np.isfinite(losses36).all()
    assert fit_launched[2] == 0 and fit_launched[3] > 0
    assert held36["fitted"] < held36["perturbed"], (
        "the light-NEE fit did not lower the loss")

    # --- 37-39. debug views, an HDRI file, sharding
    t37 = time.perf_counter()
    r37 = phase37(dev, card)
    r38 = phase38(dev, card)
    r39 = phase39(dev, card)
    print(f"[39] phases 37-39 took {time.perf_counter() - t37:.1f} s",
          flush=True)

    # --- 40-41. the wavefront scheduler, the scripts
    t40 = time.perf_counter()
    r40 = phase40(dev, card)
    r41 = phase41(card)
    print(f"[41] phases 40-41 took {time.perf_counter() - t40:.1f} s",
          flush=True)

    # --- 42. light-NEE gradients past the record budget
    r42 = phase42(dev, card)

    # --- 43. the chunk node's lane_sum and sum_groups
    r43 = phase43(dev, card)

    # --- 44. the chunk node under the sky
    r44 = phase44(dev, card)

    # --- 24. the record of every kernel: bounds from the work each
    # launch shape needs on these inputs
    w_a = _path_work(scene, o, d, cam.far, sidx, seed, st_a)
    w_b = _path_work(glass, o_g, d_g, cam.far, sidx_g, seed_g, st_g)
    w_c = _path_work(spheres, o_e, d_e, sky_cam.far, sidx_e, seed_e, st_e)
    n = o.shape[0]
    tab_a, tab_b, tab_c = (mk._scene_tables(x) for x in (scene, glass,
                                                         spheres))
    k_mat = 12 * 4 * scene.materials.count
    # a launch from pixels reads 8 bytes a ray (its pixel; the camera block
    # is 96 bytes a launch) and writes 40, or 48 with env NEE
    bounds = {
        "B1a": _bound(n * 48 + 96 + _table_bytes(tab_a),
                      _path_ops(w_a, False, False, makes_rays=n)),
        "B1b": _bound(n * 48 + 96 + _table_bytes(tab_b),
                      _path_ops(w_b, True, False, makes_rays=n)),
        "B1c": _bound(n * 56 + 96 + _table_bytes((*tab_c, env_tab)),
                      _path_ops(w_c, False, True, makes_rays=n)),
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
    bounds.update(bounds_new)
    # the record route's sweep, on both tiers; the replay's bound beside it
    for name, r in (*rec28.items(), *rec35.items()):
        if name in bounds:
            r["replay_bound"] = bounds[name]
        bounds[name] = r["bound"]
    print(f"[24] path work at the launch shapes: B1a {w_a}, B1b {w_b}, B1c "
          f"{w_c}; bounds (ms, by) {bounds}", flush=True)

    def redesigned(name, prof):
        """The extra keys of a variant redesigned with its rays made in
        the kernel: phase 27's times and the profiled frame."""
        t = times27[name]
        return dict(
            device_ms=t["pixels"][1], explicit_rays_ms=t["rays"][0],
            explicit_rays_device_ms=t["rays"][1],
            one_ray_a_thread_device_ms=t["rays, one a thread"][1],
            refill_bit_for_bit=all(v for k, v in refill26.items()
                                   if k[0] == name),
            frame_cuda_launches=prof["cuda_launches"],
            frame_device_busy_ms=prof["busy_ms"],
            frame_device_idle_share=prof["idle_share"])

    def sweep_keys(name, r):
        """The extra keys of a variant whose main path takes the record
        route: its sweep's (`record_route`), the recording forward's and
        the replay's beside it, timed on the same rays."""
        t = r["times"]
        return dict(
            registers=r["res"][0], spill_store_bytes=r["res"][1],
            kernel="adjoint_sweep", transcript_route="recorded",
            device_ms=t["sweep"][1], smem_bytes_per_block=r["smem_bytes"],
            record_rays_apart_ids_floats=r["rec_rays_apart"],
            sweep_vs_plain_worst_ratio=r["sweep_ratio"],
            record_vs_plain_max_rel_err=r["rec_err"],
            bound_ops_ms=r["ops_ms"], shaded_bounces=r["shaded"],
            record_bytes_per_launch=r["record_bytes"],
            record_written_bytes=r["record_written_bytes"],
            forward_variant=r["forward_variant"],
            forward_ms=t["forward"][0], forward_device_ms=t["forward"][1],
            forward_record_ms=t["forward with the record"][0],
            forward_record_device_ms=t["forward with the record"][1],
            forward_record_registers=r["forward_res"][0],
            forward_record_spill_store_bytes=r["forward_res"][1],
            replay_ms=t["replay"][0], replay_device_ms=t["replay"][1],
            replay_registers=res[name][0],
            replay_bound_ms=r.get("replay_bound", (None,))[0])

    def entry(name, replaces, source, launches, err, k_ms, p_ms,
              library_ms=None, **extra):
        # the record's own keys are the ones given here; extras add keys
        assert not set(extra) & {"route", "source", "replaces", "ms",
                                 "plain_ms", "bound_ms", "bound_by"}, extra
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": float(np.mean(k_ms)),
                "plain_ms": float(np.mean(p_ms)),
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": library_ms, **extra}

    mega = "halogen_tpu_torch/csrc/megakernel.cu"
    adjs = "halogen_tpu_torch/csrc/adjoint.cu"
    trav = "halogen_tpu_torch/csrc/traverse.cu"
    reg = lambda name: dict(registers=res[name][0],
                            spill_store_bytes=res[name][1])
    dmain = b1d["B1b+d"]
    kernels = [
        entry("B1a", "halogen_tpu/kernels/megakernel.py:945", mega, launches,
              err27["B1a"], times27["B1a"]["pixels"][0], plain27["B1a"],
              **reg("B1a"), explicit_rays_max_abs_err=max_err,
              explicit_rays_plain_ms=plain_ms,
              **redesigned("B1a", prof6), own_rays=rays25,
              rays_outside_tol=int(n_bad), rays=n, parity_max_abs_err=parity,
              frame_ms=dt / 4 * 1000.0,
              plain_frame_ms=plain_frame_s * 1000.0, mrays_per_s=mrays,
              build_s=build_s),
        entry("B1b", "halogen_tpu/kernels/megakernel.py:225", mega,
              main14["glass"][0], err27["B1b"], times27["B1b"]["pixels"][0],
              plain27["B1b"], **reg("B1b"),
              explicit_rays_max_abs_err=err13["B1b"],
              explicit_rays_plain_ms=times13["B1b"][1],
              **redesigned("B1b", main14["glass"][4]), parity_max_abs_err={
                  k: v for k, v in parity11.items() if "glass" in k},
              frame_ms=main14["glass"][2] * 1000.0,
              mrays_per_s=main14["glass"][1]),
        entry("B1c", "halogen_tpu/kernels/megakernel.py:1380", mega,
              main14["envmap_1024"][0], err27["B1c"],
              times27["B1c"]["pixels"][0], plain27["B1c"], **reg("B1c"),
              explicit_rays_max_abs_err=err13["B1c"],
              explicit_rays_plain_ms=times13["B1c"][1],
              **redesigned("B1c", main14["envmap_1024"][4]),
              parity_max_abs_err={
                  k: v for k, v in parity11.items() if "sky" in k},
              frame_ms=main14["envmap_1024"][2] * 1000.0,
              mrays_per_s=main14["envmap_1024"][1]),
        entry("B1d", "halogen_tpu/kernels/megakernel.py:523", mega,
              launches20[0], err27["B1b+d"], times27["B1b+d"]["pixels"][0],
              plain27["B1b+d"], **reg("B1b+d"), plain_rays=16384,
              device_ms=times27["B1b+d"]["pixels"][1],
              explicit_rays_ms=dmain["ms"],
              explicit_rays_device_ms=dmain["device_ms"],
              refilling_variant_max_abs_err=err27["B1c+d"],
              parity_max_abs_err=parity17,
              variants={k: dict(ms=v["ms"], device_ms=v["device_ms"],
                                plain_ms=v["plain_ms"],
                                bound_ms=v["bound"][0],
                                registers=v["res"][0],
                                spill_store_bytes=v["res"][1])
                        for k, v in b1d.items()},
              frame_ms=dt20 / 2 * 1000.0, mrays_per_s=mrays20,
              device_idle_share=idle20,
              frame_cuda_launches=prof20["cuda_launches"],
              frame_device_busy_ms=prof20["busy_ms"]),
        entry("B2", "halogen_tpu/kernels/adjoint.py:80", adjs,
              fb_launches[1], rec35["B2"]["err"],
              rec35["B2"]["times"]["sweep"][0],
              rec35["B2"]["times"]["sweep plain"][0],
              **sweep_keys("B2", rec35["B2"]),
              replay_max_abs_err=adj_err, replay_events_ms=adj_ms,
              replay_plain_ms=adj_plain_ms,
              replay_global_route_registers=res["B2 global"],
              smem_bytes_per_block_replay=adj.smem_bytes(scene, st_a),
              routes_same_bits=routes21["B2"]["same_bits"],
              in_turns_with_B1a=turns23["B2"],
              replay_parity_max_abs_err=adj_parity,
              main_path="cornell_glossy_256_fwd_bwd (phase 9)",
              fwd_bwd_mrays_per_s=fb_mrays,
              fwd_bwd_step_ms=dt9 / 2 * 1000.0,
              step_cuda_launches=prof9["cuda_launches"],
              step_device_busy_ms=prof9["busy_ms"],
              step_device_idle_share=prof9["idle_share"],
              step_peak_bytes=peak9, replay_step_ms=rep9[0] * 1000.0,
              replay_step_peak_bytes=rep9[1],
              fit_s_per_step_median=fit_s,
              fit_loss_first_last=[losses[0], losses[-1]],
              fit_albedo_err_before_after=[err0, err1],
              fit_held_out_loss=held),
        entry("B2b", "halogen_tpu/kernels/adjoint.py:244", adjs, fb15[1],
              rec35["B2b"]["err"], rec35["B2b"]["times"]["sweep"][0],
              rec35["B2b"]["times"]["sweep plain"][0],
              **sweep_keys("B2b", rec35["B2b"]),
              replay_max_abs_err=b2b_err, replay_events_ms=b2b_k,
              replay_plain_ms=b2b_p,
              replay_global_route_registers=res["B2b global"],
              smem_bytes_per_block_replay=adj.smem_bytes(glass, st_g),
              routes_same_bits=routes21["B2b"]["same_bits"],
              global_route_max_abs_err=g21_err,
              in_turns_with_B1b=turns23["B2b"],
              replay_parity_max_abs_err=adj15,
              variants={k: dict(sweep_ms=v["times"]["sweep"][0],
                                sweep_device_ms=v["times"]["sweep"][1],
                                replay_device_ms=v["times"]["replay"][1],
                                bound_ms=v["bound"][0],
                                registers=v["res"][0],
                                spill_store_bytes=v["res"][1])
                        for k, v in rec35.items()},
              main_path="glass_box_256_fwd_bwd (phase 15)",
              fwd_bwd_mrays_per_s=fb15_mrays,
              fwd_bwd_step_ms=dt15 / 2 * 1000.0,
              step_cuda_launches=prof15["cuda_launches"],
              step_device_busy_ms=prof15["busy_ms"],
              step_device_idle_share=prof15["idle_share"],
              step_peak_bytes=peak15, replay_step_ms=rep15[0] * 1000.0,
              replay_step_peak_bytes=rep15[1]),
        entry("B3", "halogen_tpu/kernels/bvh_pallas.py:142", trav,
              b3_launches, b3_err, times19["camera"][0], b3_plain_ms,
              **reg("B3"), plain_rays=16384,
              device_ms=times19["camera"][1],
              bounce_rays_ms=times19["bounce"][0],
              bounce_rays_device_ms=times19["bounce"][1],
              deep_strip_max_abs_err=strip_err),
    ]
    skys = "halogen_tpu_torch/csrc/sky.cu"
    vjp = "halogen_tpu/kernels/megakernel.py:1953"  # the lockstep vjp
    step = lambda name: steps31[name]
    # B2b+d and B2+d: the record route's sweep (adjoint_sweep), which the
    # main path's steps launch; beside it the replay it replaced and the
    # recording forward, timed on the same rays (phase 28)
    for name, path in (("B2b+d", "glass_dragon fwd+bwd"),
                       ("B2+d", "metal_dragon fwd+bwd 256")):
        a28, r28 = adj28[name], rec28[name]
        t = r28["times"]
        rep_step = step(path + " replay")
        r28["replay_bound"] = a28["bound"]
        kernels.append(entry(
            name, "halogen_tpu/kernels/adjoint.py:80", adjs,
            step(path)["launches"]["sweep"], r28["err"], t["sweep"][0],
            t["sweep plain"][0], **sweep_keys(name, r28), extends=vjp,
            replay_max_abs_err=a28["err"], replay_plain_ms=a28["plain_ms"],
            replay_plain_rays=16384,
            smem_bytes_per_block_replay=a28["smem_bytes"], main_path=path,
            step_ms=step(path)["step_ms"],
            fwd_bwd_mrays_per_s=step(path)["mrays_fwd_bwd"],
            step_cuda_launches=step(path)["profile"]["cuda_launches"],
            step_device_busy_ms=step(path)["profile"]["busy_ms"],
            step_device_idle_share=step(path)["profile"]["idle_share"],
            step_peak_bytes=step(path)["peak_bytes"],
            replay_step_ms=rep_step["step_ms"],
            replay_fwd_bwd_mrays_per_s=rep_step["mrays_fwd_bwd"],
            replay_step_device_busy_ms=rep_step["profile"]["busy_ms"],
            replay_step_device_idle_share=rep_step["profile"]["idle_share"],
            replay_step_peak_bytes=rep_step["peak_bytes"],
            variants={k: dict(sweep_ms=v["times"]["sweep"][0],
                              sweep_device_ms=v["times"]["sweep"][1],
                              replay_device_ms=v["times"]["replay"][1],
                              bound_ms=v["bound"][0], registers=v["res"][0],
                              spill_store_bytes=v["res"][1])
                      for k, v in rec28.items()}))
    # B2c and B2c+n: the record route's sweep at the envmap_1024 launch
    # shape (phase 35), the replay beside it (phase 30) and the steps
    for name, path in (("B2c", "sky_cornell fwd+bwd 256"),
                       ("B2c+n", "envmap_1024 fwd+bwd")):
        t30, r35 = times30[name], rec35[name]
        rep_step = step(path + " replay")
        kernels.append(entry(
            name, "halogen_tpu/kernels/adjoint.py:80", adjs,
            step(path)["launches"]["sweep"], r35["err"],
            r35["times"]["sweep"][0], r35["times"]["sweep plain"][0],
            **sweep_keys(name, r35), replay_events_ms=t30["ms"],
            replay_plain_ms=t30["plain_ms"], replay_max_abs_err=t30["err"],
            replay_transcript_route=t30["route"],
            replay_spill_store_bytes=t30["res"][1],
            extends=vjp, main_path=path,
            replay_parity_max_abs_err={k: v for k, v in adj30.items()
                                       if k.startswith(name[:3])},
            step_ms=step(path)["step_ms"],
            fwd_bwd_mrays_per_s=step(path)["mrays_fwd_bwd"],
            step_cuda_launches=step(path)["profile"]["cuda_launches"],
            step_device_busy_ms=step(path)["profile"]["busy_ms"],
            step_device_idle_share=step(path)["profile"]["idle_share"],
            step_peak_bytes=step(path)["peak_bytes"],
            replay_step_ms=rep_step["step_ms"],
            replay_step_device_busy_ms=rep_step["profile"]["busy_ms"],
            replay_step_device_idle_share=rep_step["profile"]["idle_share"],
            replay_step_peak_bytes=rep_step["peak_bytes"]))
    t29f, t29b = times29["sky forward"], times29["sky backward"]
    kernels.append(entry(
        "sky forward", "halogen_tpu/integrator/trace.py:460", skys,
        main14["envmap_1024"][5], sky29["envmap_1024"]["fwd_err"], t29f[0],
        t29f[2], **reg("sky forward"), device_ms=t29f[1],
        main_path="envmap_1024 frame (phase 14)",
        frame_ms=main14["envmap_1024"][2] * 1000.0,
        frame_cuda_launches=main14["envmap_1024"][4]["cuda_launches"],
        frame_device_idle_share=main14["envmap_1024"][4]["idle_share"],
        parity_max_abs_err={k: v["fwd_err"] for k, v in sky29.items()}))
    launches31 = step("envmap_1024 fwd+bwd")["launches"]

    def stage(t, library_call):
        return dict(ms=float(np.mean(t["ms"])), device_ms=t["device_ms"],
                    bound_ms=t["bound"][0], bound_by=t["bound"][1],
                    library_ms=t.get("library_ms"),
                    library_call=library_call)

    scat_e = scat29["envmap_1024 taps"]
    kernels.append(entry(
        "sky backward", "halogen_tpu/scene/envmap.py:360", skys,
        launches31["sky_backward"],
        max(max(v["mip_err"]) for v in sky29.values()), t29b[0], t29b[2],
        library_ms=float(np.mean(lib29_ms)), **reg("sky backward"),
        ordering_registers={k: res[f"sky ordering {k}"][0]
                            for k in ("count", "scan", "scatter")},
        sums_registers=res["sky backward sums"][0],
        ordering_launches=launches31["sky_ordering"],
        sums_launches=launches31["sky_sums"],
        device_ms_per_kernel_launch=t29b[1], device_ms=bwd_call_ms,
        stages={
            "taps": dict(stage(taps_ms, None), kernel="sky_backward_taps"),
            "ordering": dict(stage(scat_e["stages"]["ordering"],
                                   "torch.sort(stable=True)"),
                             kernel="sky_radix_count, _scan, _scatter"),
            "sums": dict(stage(scat_e["stages"]["sums"], "index_add_"),
                         kernel="sky_reduce_texels")},
        scatters={k: dict(taps=v["taps"], kept=v["kept"],
                          texels=v["texels"],
                          order_equals_torch_sort=v["order_equal"],
                          repeat=v["repeat"],
                          equals_model=v["model_bits"],
                          mip_max_abs_err=v["mip_err"],
                          ordering=stage(v["stages"]["ordering"],
                                         "torch.sort(stable=True)"),
                          sums=stage(v["stages"]["sums"], "index_add_"),
                          ordering_and_sums_ms=float(np.mean(
                              v["stages"]["ordering and sums"]["ms"])))
                  for k, v in scat29.items()},
        main_path="envmap_1024 fwd+bwd", library_call="index_add_",
        parity_max_abs_err=sky29))
    for name, route, replaces in (
            ("B4", "TREELET", "halogen_tpu/kernels/treelet_bvh.py:192"),
            ("B5", "FLATLET", "halogen_tpu/kernels/flatlet.py:199"),
            ("B6", "RAYLET", "halogen_tpu/kernels/raylet.py:208")):
        bounds[name] = bounds["B3"]
        kernels.append(entry(
            name, replaces, trav, routes16[route][0], routes16[route][1],
            times19["camera"][0], b3_plain_ms, **reg("B3"), plain_rays=16384,
            served_by="B3", intersector=route))
    # B1e's variants: the brute tier's timed on Cornell glossy (B1e), the
    # BVH tier's on the glass dragon (B1b+e+d); the lockstep's light NEE is
    # what they replace (the Pallas kernel has no light-NEE variant)
    lnee = "halogen_tpu/integrator/trace.py:332"
    for name, timed, path in (("B1e", "B1e", "cornell_glossy"),
                              ("B1e+d", "B1b+e+d", "glass_dragon")):
        t, m33 = times32[timed], main33[path]
        bvh_tier = name.endswith("+d")
        tier = {k: v[1] for k, v in parity32.items()
                if v[0].endswith("+d") == bvh_tier}
        bounds[name] = t["bound"]
        kernels.append(entry(
            name, lnee, mega, m33["launches"], max(tier.values()), t["ms"],
            t["plain_ms"], registers=t["res"][0], spill_store_bytes=t["res"][1],
            timed_variant=timed, plain_rays=t["plain_rays"],
            device_ms=t["device_ms"], launch_shape_max_abs_err=t["err"],
            variant_registers={k: res[k] for k in sorted(light_variants)
                               if k.endswith("+d") == bvh_tier},
            parity_max_abs_err=tier,
            frame_mean_kernel_plain_rel={
                k: means32[k] for k, v in parity32.items()
                if v[0].endswith("+d") == bvh_tier},
            main_path=f"{path} with light NEE (phase 33)",
            **({"bound_counts": "the culled shadow scan: a plane test a "
                "triangle, Möller-Trumbore where it does not cull",
                "bound_ms_full_scan": t["bound_full_scan"][0],
                "mt_tests_per_shadow_ray": probe32b[
                    "cornell_glossy at the launch shape (B1e)"][
                    "mt_tests_per_shadow_ray_culled"],
                "mt_tests_per_shadow_ray_full": probe32b[
                    "cornell_glossy at the launch shape (B1e)"][
                    "mt_tests_per_shadow_ray_full"],
                "split_ms": split32b} if not bvh_tier else {}),
            frame_ms=m33["frame_ms"], mrays_per_s=m33["mrays_per_s"],
            frame_cuda_launches=m33["profile"]["cuda_launches"],
            frame_device_busy_ms=m33["profile"]["busy_ms"],
            frame_device_idle_share=m33["profile"]["idle_share"]))
    # B2+l: the recording B1e and B1e+d (timed on B1e's and B1b+e+d's
    # rays, in turns with them without the record) and the light sweep,
    # which the light-NEE fwd+bwd steps of phase 36 launch
    for name, path in (("B1e recording", "cornell_glossy_256_fwd_bwd_light"),
                       ("B1e+d recording",
                        "glass_dragon_512_fwd_bwd_light")):
        t, step36 = times36[name], steps36[path]
        bounds[name] = t["bound"]
        kernels.append(entry(
            name, lnee, mega, step36["launches"]["record"], t["err"],
            t["ms"], t["plain_ms"], registers=t["res"][0],
            spill_store_bytes=t["res"][1],
            timed_variant=f"{t['timed']} record", device_ms=t["device_ms"],
            forward_ms=float(np.mean(t["forward_ms"])),
            forward_registers=t["forward_res"][0],
            plain_version="adjoint.record_transcript_reference",
            plain_rays=t["plain_rays"], record_ids_apart=t["ids_apart"],
            record_floats_apart=t["floats_apart"],
            shaded_bounces=t["shaded"],
            record_bytes_per_launch=t["record_bytes"],
            record_written_bytes=t["record_written_bytes"],
            variant_registers={k: res[k] for k in sorted(
                light_record_variants)
                if k.removesuffix(" record").endswith("+d")
                == name.startswith("B1e+d")},
            parity=check36, main_path=f"{path} (phase 36)",
            step_ms=step36["step_ms"],
            fwd_bwd_mrays_per_s=step36["mrays_fwd_bwd"],
            step_cuda_launches=step36["profile"]["cuda_launches"],
            step_device_busy_ms=step36["profile"]["busy_ms"],
            step_device_idle_share=step36["profile"]["idle_share"],
            step_peak_bytes=step36["peak_bytes"],
            step_record_bytes=step36["record_bytes"]))
    t = times36["B2+l"]
    bounds["B2+l"] = t["bound"]
    step36 = steps36["cornell_glossy_256_fwd_bwd_light"]
    kernels.append(entry(
        "B2+l", "halogen_tpu/kernels/adjoint.py:80", adjs,
        step36["launches"]["sweep"], t["err"], t["ms"], t["plain_ms"],
        registers=t["res"][0], spill_store_bytes=t["res"][1],
        kernel="adjoint_sweep<*, *, true>", transcript_route="recorded",
        extends="halogen_tpu/integrator/trace.py:332",
        device_ms=t["device_ms"],
        plain_version="adjoint.sweep_reference", worst_ratio=t["ratio"],
        bound_ops_ms=t["ops_ms"], bound_bytes=t["bytes"],
        shaded_bounces=t["shaded"],
        variant_registers={k: res[k] for k in sorted(light_sweep_variants)},
        parity={k: dict(sweep_max_abs_err=v["sweep_max_abs_err"],
                        route_worst_ratio=v["route_worst_ratio"])
                for k, v in check36.items()},
        main_path="cornell_glossy_256_fwd_bwd_light (phase 36)",
        steps={k: dict(step_ms=v["step_ms"],
                       fwd_bwd_mrays_per_s=v["mrays_fwd_bwd"],
                       launches=v["launches"],
                       cuda_launches=v["profile"]["cuda_launches"],
                       device_busy_ms=v["profile"]["busy_ms"],
                       device_idle_share=v["profile"]["idle_share"],
                       peak_bytes=v["peak_bytes"],
                       record_bytes=v["record_bytes"])
               for k, v in steps36.items()},
        fit_held_out_loss=held36, fit_step_ms_median=fit36_ms))
    # the chunk node's two small kernels (phase 43): lane_sum timed at a
    # fit group's shape, sum_groups' device time in a fit step's backward
    lane43, sweep43, launches43 = r43["lane"], r43["sweep"], r43["launches"]
    fit_shape = lane43["10 floats a row, 4 lanes"]
    bounds["lane_sum"] = fit_shape["bound"]
    bounds["sum_groups"] = sweep43["bound"]
    kernels.append(entry(
        "lane_sum", "halogen_tpu/integrator/trace.py:800", mega,
        {k: v["megakernel.lane_sums"] for k, v in launches43.items()}, 0.0,
        fit_shape["ms"], fit_shape["plain_ms"], timed_shape=(
            "262144 rays, 10 floats a row, 4 lanes a pixel (a Cornell fit "
            "group)"), plain_version="acc + col.reshape(n, spp_block, 3)"
        ".sum(dim=1)", bit_for_bit=True,
        shapes={k: dict(ms=v["ms"], plain_ms=v["plain_ms"],
                        bound_ms=v["bound"][0]) for k, v in lane43.items()},
        main_path="every chunk node"))
    kernels.append(entry(
        "sum_groups", "halogen_tpu/integrator/trace.py:802", adjs,
        {k: v["adjoint.group_sums"] for k, v in launches43.items()},
        sweep43["max_abs_err"], sweep43["sum_groups_device_ms"],
        sweep43["sum_plain_ms"], device_ms=sweep43["sum_groups_device_ms"],
        plain_version="autograd's sum of the groups' [K, 12], newest first",
        bit_for_bit=True, groups=sweep43["groups"],
        sweep_chunk_ms=sweep43["ms"],
        sweep_chunk_device_ms=sweep43["chunk_device_ms"],
        per_group_sweeps_ms=sweep43["plain_ms"],
        main_path="the chunk node's backward (adjoint.sweep_chunk)"))
    by_name = {k["name"]: k for k in kernels}
    by_name["B3"]["count_views"] = r37
    by_name["sky backward"]["hdri_2048"] = r38
    by_name["B1d"]["dragons_hero_sharded"] = r39
    by_name["B3"]["wavefront"] = r40
    for name in ("B1e recording", "B1e+d recording", "B2+l"):
        by_name[name]["rerecord_launches"] = {
            k: v["launches"] for k, v in r42["steps"].items()}
    by_name["B2+l"]["rerecord"] = r42
    by_name["sky backward"]["chunk_node_fit_step"] = r44
    by_name["B1d"]["scripts"] = {k: {kk: vv for kk, vv in v.items()
                                     if kk != "record"}
                                 for k, v in r41.items()}
    print(f"[24] chip_smoke took {time.perf_counter() - t_main:.1f} s "
          f"after its imports", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--rank-worker":
        sys.exit(_rank_worker(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4]))
    sys.exit(main())
